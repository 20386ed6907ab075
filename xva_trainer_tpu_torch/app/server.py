"""Task API server speaking the reference's JSON protocol, on the port.

Counterpart of ``xva_trainer_tpu/app/server.py`` (reference server.py):
- websocket on :8001 (server.py:27,247-254): JSON ``{model, task, data}``
  with tasks ``runTask`` / ``startTraining`` / ``resume`` / ``pause`` /
  ``stop`` (:135-208); events back: ``task_info`` / ``tasks_next`` /
  ``tasks_error`` / ``TRAINING_ERROR``.
- HTTP on :8002 (:26,360): ``/setDevice``, ``/checkReady``, ``/exportWav``,
  ``/getAudioLengthOfDir``, ``/stopServer`` (:286-346), and the UI's data,
  queue, settings, telemetry, profiler and export endpoints.

Training runs as an asyncio task inside ONE event loop, its blocking stages
on worker threads; the task runner is a single-owner state machine. Every
job runs on the manager's device (``cuda`` unless ``/setDevice`` says
``cpu``). The websocket is ``app/ws.py`` (stdlib only; no ``websockets``
package). What differs from the JAX server:

- one card, so no mesh (``make_mesh_for_batch``);
- ``/exportWav`` on an output directory restores the newest
  ``xVAPitch_<n>.pt`` of the port's ``CheckpointManager``; a directory that
  holds only the JAX package's orbax checkpoints is refused;
- 13 of the 16 tools are ported (``tools.TOOL_REGISTRY``): a ``runTask``
  or a text-quality pass that needs ``transcribe``, ``make_srt`` or ``ass``
  fails with an error naming the tool;
- ``/stopServer`` stops a running job and makes ``serve_with_http`` close
  both servers and return; the JAX server's process ends when the
  ``SystemExit`` it raises leaves the event loop.
"""
from __future__ import annotations

import asyncio
import functools
import json
import logging
import os
import threading
import time
import traceback
from logging.handlers import RotatingFileHandler
from typing import Dict, Optional


def _ui_html(ws_port: int = 8001) -> str:
    """The single-page UI served at '/'.

    The page's ws port is substituted at serve time so --ws-port / ports.txt
    overrides reach the browser."""
    p = os.path.join(os.path.dirname(__file__), "ui.html")
    with open(p, encoding="utf8") as f:
        return f.read().replace("const wsPort = 8001;",
                                f"const wsPort = {int(ws_port)};")


def load_app_settings() -> Dict:
    """Merge persisted app settings over the defaults (unknown keys dropped,
    so a stale file can't inject settings a newer server doesn't know)."""
    out = dict(APP_SETTINGS_DEFAULTS)
    p = os.path.join(os.getcwd(), APP_SETTINGS_FILE)
    try:
        with open(p) as f:
            saved = json.load(f)
        out.update({k: v for k, v in saved.items()
                    if k in APP_SETTINGS_DEFAULTS})
    except (OSError, json.JSONDecodeError, AttributeError):
        pass
    return out


def make_logger(path: str = "server.log") -> logging.Logger:
    """Rotating file logger, 2MB × 5 (reference server.py:68-97). Named
    apart from the JAX package's, so a process that imports both keeps two
    sets of handlers."""
    logger = logging.getLogger("xva_trainer_tpu_torch")
    if not logger.handlers:
        logger.setLevel(logging.DEBUG)
        fh = RotatingFileHandler(path, maxBytes=2 * 1024 * 1024, backupCount=5)
        fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        logger.addHandler(fh)
    return logger


class TrainingSession:
    """Single-owner trainer lifecycle: start/pause/resume/stop + batch queue.

    The queue holds multiple dataset configs and persists across sessions in
    ``training_queue.json`` (reference javascript/train.js:258,350-368 — the
    reference keeps it in the frontend; here the server owns it so headless
    runs get the same behavior). Pause is warm: the trainer thread spins on
    ``trainer.paused`` with its models and optimiser state on the card, so
    resume continues at once (reference xva_train.py:569-573).

    A job's blocking stages run on worker threads (``_in_thread``);
    ``workers_idle`` waits until none is running. ``stop`` cancels the
    asyncio task, which does not stop a worker thread: the trainer's
    ``stop_requested`` ends its loop, and the rest of that stage runs on.
    """

    QUEUE_FILE = "training_queue.json"

    def __init__(self, server: "AppServer"):
        self.server = server
        self.task: Optional[asyncio.Task] = None
        self.trainer = None
        self.paused = False
        self.queue: list = []
        self.queue_index = 0
        self._workers = 0
        self._workers_cv = threading.Condition()
        self.stage_seconds: list = []  # (stage, seconds) of each worker call

    def running(self) -> bool:
        return self.task is not None and not self.task.done()

    # ---------------- worker threads ----------------

    async def _in_thread(self, fn, *args, **kwargs):
        """``asyncio.to_thread(fn, ...)``, counted until the call returns on
        its thread (a cancelled await leaves the thread running); each
        call's seconds go to ``stage_seconds`` and the log."""
        f = getattr(fn, "func", fn)
        name = getattr(f, "__qualname__", repr(f))
        state = ["pending"]  # → "running", or "dropped" if cancelled before it ran

        def done():
            with self._workers_cv:
                self._workers -= 1
                self._workers_cv.notify_all()

        def call():
            with self._workers_cv:
                if state[0] == "dropped":
                    return None
                state[0] = "running"
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                self.stage_seconds.append((name, dt))
                self.server.logger.info(f"[job] {name}: {dt:.3f} s")
                done()

        with self._workers_cv:
            self._workers += 1
        try:
            return await asyncio.to_thread(call)
        except asyncio.CancelledError:
            with self._workers_cv:
                never_ran = state[0] == "pending"
                if never_ran:
                    state[0] = "dropped"
            if never_ran:
                done()
            raise

    def workers_idle(self, timeout: Optional[float] = None) -> bool:
        """Wait until no job stage runs on a worker thread; False on timeout."""
        with self._workers_cv:
            return self._workers_cv.wait_for(lambda: self._workers == 0, timeout)

    # ---------------- queue persistence ----------------

    def _queue_path(self) -> str:
        return os.path.join(os.getcwd(), self.QUEUE_FILE)

    def save_queue(self):
        with open(self._queue_path(), "w") as f:
            json.dump({"queue": self.queue, "index": self.queue_index}, f,
                      indent=2)

    def load_queue(self) -> bool:
        p = self._queue_path()
        if not os.path.exists(p):
            return False
        with open(p) as f:
            data = json.load(f)
        self.queue = data.get("queue", [])
        self.queue_index = data.get("index", 0)
        return bool(self.queue)

    async def start(self, data: Dict, websocket, resume: bool = False):
        if self.running():
            # a start while training queues the dataset (reference queue
            # semantics, train.js:258) instead of silently dropping it
            if isinstance(data, dict) and data.get("dataset_path"):
                self.queue.append(data)
                self.save_queue()
                if websocket:
                    await websocket.send(json.dumps({
                        "key": "task_info",
                        "data": f"queued ({len(self.queue)} total): "
                                f"{data['dataset_path']}",
                    }))
            return
        if resume and not data and self.load_queue():
            pass  # continue the persisted queue
        elif isinstance(data, dict) and "queue" in data:
            self.queue = list(data["queue"])
            self.queue_index = 0
        elif isinstance(data, dict) and data.get("dataset_path"):
            self.queue = [data]
            self.queue_index = 0
        else:
            # resume with nothing persisted / an empty message: no-op rather
            # than enqueueing {} and crashing in _run
            if websocket:
                await websocket.send(json.dumps({
                    "key": "tasks_error",
                    "data": "nothing to resume: no dataset_path and no "
                            "persisted training queue",
                }))
            return
        self.save_queue()
        self.task = asyncio.create_task(self._run_queue(websocket))

    async def _run_queue(self, websocket):
        try:
            while self.queue_index < len(self.queue):
                item = self.queue[self.queue_index]
                await self._run(item, websocket)
                self.queue_index += 1
                self.save_queue()
            if os.path.exists(self._queue_path()):
                os.remove(self._queue_path())
            if websocket:
                await websocket.send(json.dumps({"key": "tasks_next"}))
        except asyncio.CancelledError:
            self.save_queue()
            raise
        except Exception:
            err = traceback.format_exc()
            self.server.logger.error(err)
            if websocket:
                await websocket.send(
                    json.dumps({"key": "TRAINING_ERROR", "data": err})
                )

    async def _run(self, data: Dict, websocket):
        model_type = (data.get("model_type") or "xVAPitch").lower()
        if "fastpitch" in model_type:
            await self._run_v2(data, websocket)
        else:
            await self._run_v3(data, websocket)

    async def _run_v3(self, data: Dict, websocket):
        from ..data.language_manager import LanguageManager
        from ..data.xva_dataset import (
            XvaBatcher,
            XvaFeatureCache,
            extract_speaker_embeddings,
            get_dataset_embedding,
            read_priors_datasets,
        )
        from ..models.xvapitch import XVAPitchConfig
        from ..train.xvapitch_trainer import (
            XVAPitchTrainer,
            XvaTrainConfig,
            pre_cache_g2p,
            preprocess_audio,
        )
        from ..utils.config import build_config

        dev = self.server.manager.device
        dataset_path = data["dataset_path"]
        output_path = data["output_path"]
        lang = data.get("lang", "en")
        bs = int(data.get("batch_size", 64))
        # the speaker encoder on the job's device (the data functions' own
        # default is one on cuda)
        encoder = await self._in_thread(self.server.manager.sync_init_model,
                                        "speaker_encoder")

        def text_to_ids(text):
            return self.server._text_to_ids(text, lang)

        # full reference flow: loudness preprocess → g2p pre-cache → per-item
        # speaker embs → feature cache → dataset centroid
        await self._in_thread(preprocess_audio, dataset_path)
        await self._in_thread(pre_cache_g2p, dataset_path, lang)
        await self._in_thread(extract_speaker_embeddings, dataset_path, encoder, True)
        cache = XvaFeatureCache(dataset_path, text_to_ids, lang=lang, device=dev)
        await self._in_thread(cache.build)
        emb = await self._in_thread(get_dataset_embedding, dataset_path, encoder)
        batcher = XvaBatcher([cache], batch_size=bs, d_vector=emb["main"])

        priors_batcher = None
        priors_langs: list = []
        priors_root = data.get("priors_root")
        if priors_root and os.path.isdir(priors_root):
            langs = data.get("priors_languages") or [lang]
            dirs, priors_langs = await self._in_thread(
                read_priors_datasets, langs, [priors_root], encoder
            )
            caches = []
            for d in dirs:
                # each priors dataset tokenizes in its own language
                # (dir prefix <lang>_<name> — reference dataset.py:604-607)
                d_lang = LanguageManager.parse_language_from_dir(d) or lang

                def make_tti(l):
                    return lambda text: self.server._text_to_ids(text, l)

                c = XvaFeatureCache(d, make_tti(d_lang), lang=d_lang, device=dev)
                await self._in_thread(c.build)
                caches.append(c)
            if caches:
                priors_batcher = XvaBatcher(caches, batch_size=bs,
                                            d_vector=emb["main"])
                priors_batcher.weighted_by_language = True

        # typed-config overlays: dataclass defaults < optional JSON beside the
        # dataset < the UI/server message
        cfg, unknown = build_config(
            XvaTrainConfig,
            json_path=os.path.join(dataset_path, "train_config.json"),
            message={k: v for k, v in data.items()
                     if k not in ("dataset_path", "output_path", "model_type",
                                  "lang", "checkpoint", "priors_root",
                                  "max_steps", "queue")},
            output_dir=output_path, batch_size=bs,
            hifi_only=bool(data.get("hifi_only")),
        )
        if unknown:
            self.server.logger.info(f"[config] ignored unknown keys: {unknown}")
        model_cfg = XVAPitchConfig()
        if isinstance(data.get("model_config"), dict):
            mc = dict(data["model_config"])
            for k, v in list(mc.items()):
                if isinstance(v, list):
                    mc[k] = tuple(v)
            model_cfg = XVAPitchConfig(**mc)
        # building the models and moving them to the card takes seconds: off
        # the event loop
        trainer = await self._in_thread(XVAPitchTrainer, batcher, cfg, model_cfg,
                                        priors_batcher=priors_batcher, device=dev)
        self._attach_trainer(trainer)
        ckpt = data.get("checkpoint")
        pretrained = ckpt if (ckpt and ckpt != "[base]"
                              and str(ckpt).endswith(".pt")) else (
            os.environ.get("XVA_BASE_V3_CKPT")
        )
        # setup loads for seconds; export writes the full fp16 tree — keep
        # the event loop (ws pause/stop, http polls) responsive
        await self._in_thread(trainer.setup, True, pretrained)
        await self._in_thread(trainer.train, data.get("max_steps"))
        voice = os.path.basename(dataset_path.rstrip("/"))
        await self._in_thread(
            functools.partial(
                trainer.export, voice, lang=lang, base_emb=emb["main"],
                other_embs=emb["others"].tolist(),
                lang_capabilities=sorted(set([lang] + priors_langs)),
            )
        )

    async def _run_v2(self, data: Dict, websocket):
        from ..train.pipeline import PipelineConfig, train_v2_pipeline

        cfg = PipelineConfig(
            dataset_path=data["dataset_path"],
            output_path=data["output_path"],
            batch_size=int(data.get("batch_size", 32)),
            voice_name=os.path.basename(data["dataset_path"].rstrip("/")),
            # UI sends "true"/"false" strings; default on (reference :551)
            use_amp=str(data.get("use_amp", "true")).lower()
            in ("1", "true", "yes", "on"),
            # per-queue-item config (reference train.js:711-747)
            force_stage=int(data.get("force_stage") or 0),
            epochs_per_checkpoint=int(data.get("bkp_every_x") or 1),
        )
        await self._in_thread(
            functools.partial(train_v2_pipeline, cfg, on_trainer=self._attach_trainer,
                              device=self.server.manager.device)
        )

    def pause(self):
        """Warm pause: the trainer thread idles with its state on the card.
        A pause before the trainer object exists (preprocess/cache-build
        phase) is remembered and applied when it is constructed
        (_attach_trainer)."""
        self.paused = True
        if self.trainer is not None:
            self.trainer.paused = True

    def _attach_trainer(self, trainer):
        """Register the live trainer, applying any pre-construction pause."""
        self.trainer = trainer
        if self.paused:
            trainer.paused = True

    def resume(self):
        if self.trainer is not None:
            self.trainer.paused = False
        self.paused = False

    def stop(self):
        if self.trainer is not None:
            self.trainer.paused = False
            self.trainer.stop_requested = True
        if self.task:
            self.task.cancel()
        self.trainer = None
        self.paused = False


# App-level settings (reference javascript/settingsMenu.js:201-249: ports,
# device, default paths, theme). Server-persisted so they survive restarts
# and apply to headless runs too.
APP_SETTINGS_DEFAULTS = {
    "http_port": 8002,
    "ws_port": 8001,
    "device": "cuda",
    "datasets_path": "",
    "output_path": "",
    "theme": "dark",
    "prompt_before_delete": True,
    # explorer page size + mic-recording noise removal (reference
    # javascript/settingsMenu.js:128-145: paginationSize, removeNoise,
    # noiseRemStrength — the reference pipes recordings through sox
    # noisered with a saved noise profile, script.js:1074-1090)
    "pagination_size": 100,
    "record_noise_removal": False,
    "noise_removal_strength": 0.25,
}
APP_SETTINGS_FILE = "app_settings.json"


class AppServer:
    def __init__(self, http_port: int = 8002, ws_port: int = 8001,
                 logger: Optional[logging.Logger] = None,
                 device: Optional[str] = None):
        """``device``: the jobs' device, resolved now (raising when torch
        cannot use it); without it the manager keeps ``cuda``, unresolved
        until a job or ``/setDevice`` needs it."""
        from .manager import ModelsManager

        self.http_port = http_port
        self.ws_port = ws_port
        self.logger = logger or make_logger()
        self.manager = ModelsManager(self.logger)
        if device is not None:
            self.manager.set_device(device)
        self.training = TrainingSession(self)
        self.app_settings = load_app_settings()
        self._tq_task: Optional[asyncio.Task] = None  # text-quality pipeline
        self._tq_dataset: Optional[str] = None
        self._stop: Optional[asyncio.Future] = None   # set by /stopServer
        self.ready = True

    def save_app_settings(self) -> None:
        with open(os.path.join(os.getcwd(), APP_SETTINGS_FILE), "w") as f:
            json.dump(self.app_settings, f, indent=2)

    # ---------------- websocket protocol ----------------

    async def handle_message(self, raw: str, websocket=None) -> Optional[str]:
        """One JSON message → optional immediate reply (events go over ws)."""
        msg = json.loads(raw)
        model = (msg.get("model") or "").lower()
        task = msg.get("task") or ""
        data = msg.get("data") or {}

        # debug backdoors keyed on `model`, raw data (reference server.py:146-163)
        if model == "exit":
            raise SystemExit
        if model == "print":
            self.logger.info(str(data))
            return ""
        if model == "print_and_return":
            self.logger.info(str(data))
            return data if isinstance(data, str) else json.dumps(data)
        if model == "gettimeddata":
            for i in ("1", "2", "3"):
                await websocket.send(i)
                await asyncio.sleep(1)
            return None

        if isinstance(data, str):
            data = json.loads(data) if data else {}

        if task == "runTask":
            # a tool not ported yet raises a KeyError naming it (tasks_error)
            tool = await self.manager.init_model(model)
            await tool.runTask(data, websocket)
            return None
        if task == "startTraining":
            await self.training.start(data, websocket)
            return None
        if task == "resume":
            if self.training.running() and self.training.paused:
                self.training.resume()   # warm resume
            else:
                await self.training.start(data, websocket, resume=True)
            return None
        if task == "pause":
            self.training.pause()
            return None
        if task == "stop":
            self.training.stop()
            self.manager.drop(model)
            return None
        if task == "exit":
            raise SystemExit
        return json.dumps({"key": "tasks_error", "data": f"unknown task {task}"})

    async def websocket_handler(self, websocket):
        async for raw in websocket:
            try:
                reply = await self.handle_message(raw, websocket)
                if reply is not None:
                    await websocket.send(reply)
            except SystemExit:
                raise
            except Exception:
                err = traceback.format_exc()
                self.logger.error(err)
                try:
                    await websocket.send(
                        json.dumps({"key": "tasks_error", "data": err})
                    )
                except Exception:
                    pass

    # ---------------- HTTP endpoints ----------------

    async def handle_http(self, path: str, body: Dict) -> Dict:
        if path == "/checkReady":
            return {"ready": self.ready}
        if path == "/setDevice":
            self.manager.set_device(body.get("device", "cuda"))
            return {"ok": True}
        if path == "/getAudioLengthOfDir":
            from ..data.audio_io import load_wav

            total = 0.0
            d = body["directory"]
            for f in os.listdir(d):
                if f.endswith(".wav"):
                    y, sr = load_wav(os.path.join(d, f))
                    total += len(y) / sr
            return {"seconds": total}
        if path == "/exportWav":
            return await self._export_wav(body)
        if path == "/stopServer":
            # the JAX server's process ends here, its training thread with
            # it; the port asks a running job to stop
            self.training.stop()
            raise SystemExit
        # ---------------- UI data endpoints ----------------
        if path == "/datasetInfo":
            return self._dataset_info(body["path"])
        if path == "/updateTranscript":
            return self._update_transcript(body["path"], body["name"],
                                           body["text"])
        if path == "/deleteRecord":
            return self._delete_record(body["path"], body["name"])
        if path == "/graphs":
            p = os.path.join(body["dir"], "graphs.json")
            if os.path.exists(p):
                with open(p) as f:
                    return json.load(f)
            return {}
        if path == "/trainingLog":
            p = os.path.join(body["dir"], "training.log")
            if os.path.exists(p):
                with open(p, encoding="utf8", errors="replace") as f:
                    lines = f.read().split("\n")
                return {"lines": lines[-int(body.get("tail", 50)):]}
            return {"lines": []}
        if path == "/queue":
            return {"queue": self.training.queue,
                    "index": self.training.queue_index,
                    "running": self.training.running(),
                    "paused": self.training.paused}
        if path == "/resourceUsage":
            # host CPU/RAM/disk + the card's memory (reference
            # node-nvidia-smi graphs, package.json:17-26 — utils/telemetry.py)
            from ..utils.telemetry import snapshot

            return snapshot(body.get("disk_path", "/"))
        if path == "/toolSettingsSchema":
            # the UI generates per-tool settings forms from this (reference
            # hand-built panels, javascript/tools.js:82-488): the ported tools'
            from ..tools import TOOL_SETTINGS_SCHEMA

            return {"schema": TOOL_SETTINGS_SCHEMA}
        if path == "/profileStart":
            # on-demand torch.profiler capture of whatever the server is
            # running now, on the jobs' device; view in TensorBoard or
            # chrome://tracing
            from ..train.profiler import trace_start

            return trace_start(body.get("dir")
                               or os.path.join(os.getcwd(), "profile_traces"),
                               device=self.manager.device)
        if path == "/profileStop":
            from ..train.profiler import trace_stop

            return trace_stop()
        if path == "/updateQueueItem":
            # per-queue-item training config edits + reorder/duplicate
            # (reference javascript/train.js:258-368,711-747)
            i = int(body["index"])
            q = self.training.queue
            if 0 <= i < len(q):
                started = self.training.running() and i <= self.training.queue_index
                if body.get("remove"):
                    if started:
                        return {"ok": False, "error": "item already started"}
                    q.pop(i)
                    if i < self.training.queue_index:
                        self.training.queue_index -= 1
                elif body.get("duplicate"):
                    q.insert(i + 1, dict(q[i]))
                    if i + 1 <= self.training.queue_index:
                        self.training.queue_index += 1
                elif "move" in body:
                    j = max(0, min(len(q) - 1, int(body["move"])))
                    floor = (self.training.queue_index + 1
                             if self.training.running() else 0)
                    if started or j < floor:
                        return {"ok": False,
                                "error": "cannot move started items"}
                    q.insert(j, q.pop(i))
                    # keep the resume position pointing at the same item
                    # when a stopped mid-queue session is reordered
                    qi = self.training.queue_index
                    if i == qi:
                        self.training.queue_index = j
                    elif i < qi <= j:
                        self.training.queue_index -= 1
                    elif j <= qi < i:
                        self.training.queue_index += 1
                elif isinstance(body.get("config"), dict):
                    q[i].update(body["config"])
                self.training.save_queue()
                return {"ok": True, "queue": q}
            return {"ok": False, "error": "bad index"}
        if path == "/appSettings":
            # server-persisted app settings (reference settingsMenu.js:201-249)
            if body.get("reset"):
                # reset-to-defaults (reference reset_settings_btn,
                # settingsMenu.js:147-156)
                device_changed = (self.app_settings["device"]
                                  != APP_SETTINGS_DEFAULTS["device"])
                self.app_settings = dict(APP_SETTINGS_DEFAULTS)
                self.save_app_settings()
                if device_changed:
                    self.manager.set_device(self.app_settings["device"])
                return {"settings": self.app_settings}
            if isinstance(body.get("set"), dict):
                known = {k: v for k, v in body["set"].items()
                         if k in APP_SETTINGS_DEFAULTS}
                device_changed = ("device" in known and
                                  known["device"] != self.app_settings["device"])
                self.app_settings.update(known)
                self.save_app_settings()
                if device_changed:
                    # only on an actual change, as in the JAX server
                    self.manager.set_device(known["device"])
            return {"settings": self.app_settings}
        if path == "/importMetadata":
            return self._import_metadata(body["path"], body.get("lines") or [])
        if path == "/datasetMetadata":
            return self._dataset_metadata(body)
        if path == "/newDataset":
            return self._new_dataset(body)
        if path == "/deleteDataset":
            return self._delete_dataset(body["path"])
        if path == "/removeDuplicates":
            return self._remove_duplicates(body["path"])
        if path == "/listDatasets":
            return self._list_datasets(body.get("path"))
        if path == "/prepText":
            return self._prep_text(body)
        if path == "/cleanData":
            return self._clean_data(body["path"])
        if path == "/checkTextQuality":
            return self._start_text_quality(body)
        if path == "/textQualityStatus":
            return self._text_quality_status(body["path"])
        if path == "/exportVoice":
            return await self._export_voice(body)
        if path == "/serverLog":
            # app-logger panel (reference javascript/appLogger.js). Polled
            # every 3s while open — read only the file tail, not all 2MB.
            tail = int(body.get("tail", 80))
            for h in self.logger.handlers:
                base = getattr(h, "baseFilename", None)
                if base and os.path.exists(base):
                    with open(base, "rb") as f:
                        f.seek(0, os.SEEK_END)
                        f.seek(max(0, f.tell() - 64 * 1024))
                        text = f.read().decode("utf8", errors="replace")
                    return {"lines": text.split("\n")[-tail:]}
            return {"lines": []}
        return {"error": f"unknown path {path}"}

    def _dataset_info(self, dataset_path: str) -> Dict:
        """Dataset explorer payload: per-record transcript + duration + the
        duplicate-name check (reference javascript/script.js:243-316)."""
        wav_dir = os.path.join(dataset_path, "wavs")
        items = []
        seen = set()
        dupes = []
        meta = os.path.join(dataset_path, "metadata.csv")
        rows = []
        if os.path.exists(meta):
            with open(meta, encoding="utf8") as f:
                rows = [ln for ln in f.read().split("\n") if ln.strip()]
        # parse raw rows (read_metadata drops rows whose wav is missing —
        # the explorer must SHOW those as exists:false, script.js:243-316)
        # per-record WER column from the wer_evaluation tool's report
        # (reference explorer WER column, script.js:243-316 + index.html:59-74)
        wers = {}
        wer_path = os.path.join(dataset_path, "wer_report.txt")
        if os.path.exists(wer_path):
            with open(wer_path, encoding="utf8") as f:
                for ln in f:
                    p = [x.strip() for x in ln.split("|")]
                    if len(p) >= 2:
                        try:
                            wers[p[1]] = float(p[0])
                        except ValueError:
                            pass
        for line in rows:
            parts = line.split("|")
            stem = os.path.splitext(parts[0])[0]
            name = stem + ".wav"
            if name in seen:
                dupes.append(name)
            seen.add(name)
            item = {
                "name": name,
                "text": parts[1] if len(parts) > 1 else "",
                "exists": os.path.exists(os.path.join(wav_dir, name)),
            }
            if stem in wers:
                item["wer"] = wers[stem]
            items.append(item)
        extra = []
        if os.path.isdir(wav_dir):
            extra = sorted(set(os.listdir(wav_dir)) - seen)
        return {"items": items, "duplicates": dupes,
                "untranscribed": [f for f in extra if f.endswith(".wav")]}

    @staticmethod
    def _decode_mic_wav(wav_bytes: bytes):
        """Browser mic upload → 22050 Hz mono float32 (shared by recordings
        and the noise profile)."""
        import io

        import numpy as np
        from scipy.io import wavfile

        from ..data.audio_io import resample as _resample

        sr, data = wavfile.read(io.BytesIO(wav_bytes))
        if data.dtype.kind == "i":
            y = data.astype(np.float32) / np.iinfo(data.dtype).max
        elif data.dtype.kind == "u":  # 8-bit PCM is unsigned with +128 offset
            info = np.iinfo(data.dtype)
            y = (data.astype(np.float32) - (info.max + 1) / 2) / ((info.max + 1) / 2)
        else:
            y = data.astype(np.float32)
        if y.ndim > 1:
            y = y.mean(axis=1)
        if sr != 22050:
            y = _resample(y, sr, 22050)
        return y

    def save_recording(self, dataset_path: str, name: str, wav_bytes: bytes,
                       text: str = "") -> Dict:
        """Store a browser mic recording into <dataset>/wavs/ as 22050 Hz
        mono and register its transcript line."""
        from ..data.audio_io import save_wav

        y = self._decode_mic_wav(wav_bytes)
        name = os.path.basename(name)
        if not name.endswith(".wav"):
            name += ".wav"
        # optional mic noise removal against a saved profile (reference sox
        # noisered pipe on recordings, javascript/script.js:1074-1090)
        if self.app_settings.get("record_noise_removal"):
            prof = os.path.join(os.getcwd(), "noise_profile.wav")
            if os.path.exists(prof):
                import numpy as np
                from scipy.io import wavfile as _wf

                from ..tools.audio_tools import NoiseRemovalTool

                _, noise = _wf.read(prof)
                noise = noise.astype(np.float32) / 32767.0
                tool = NoiseRemovalTool(device=self.manager.device)
                y = tool._denoise(
                    y, tool._profile(noise),
                    float(self.app_settings.get("noise_removal_strength", 0.25)))
        wav_dir = os.path.join(dataset_path, "wavs")
        os.makedirs(wav_dir, exist_ok=True)
        save_wav(os.path.join(wav_dir, name), y)
        if text:
            self._update_transcript(dataset_path, name, text)
        return {"ok": True, "name": name, "seconds": len(y) / 22050.0}

    def save_noise_profile(self, wav_bytes: bytes) -> Dict:
        """Store a mic clip as the noise profile used by
        ``save_recording``'s optional denoise (reference keeps a
        ``noise_profile_file`` next to the app, script.js:1079)."""
        from ..data.audio_io import save_wav

        y = self._decode_mic_wav(wav_bytes)
        p = os.path.join(os.getcwd(), "noise_profile.wav")
        save_wav(p, y)
        return {"ok": True, "path": p, "seconds": len(y) / 22050.0}

    def _update_transcript(self, dataset_path: str, name: str, text: str) -> Dict:
        meta = os.path.join(dataset_path, "metadata.csv")
        rows = []
        found = False
        if os.path.exists(meta):
            with open(meta, encoding="utf8") as f:
                for line in f.read().split("\n"):
                    if not line.strip():
                        continue
                    parts = line.split("|")
                    k = parts[0]
                    if k == name or k == os.path.splitext(name)[0]:
                        # keep any extra columns (LJSpeech-style 3rd field)
                        tail = "|" + "|".join(parts[2:]) if len(parts) > 2 else ""
                        rows.append(f"{k}|{text}{tail}")
                        found = True
                    else:
                        rows.append(line)
        if not found:
            rows.append(f"{name}|{text}")
        with open(meta, "w", encoding="utf8") as f:
            f.write("\n".join(rows))
        return {"ok": True}

    def _import_metadata(self, dataset_path: str, lines) -> Dict:
        """Merge dropped .csv/.txt records into metadata.csv (reference
        drag-drop import, javascript/script.js:658-760): named rows update or
        append; nameless rows (.txt lines) get fresh auto names."""
        meta = os.path.join(dataset_path, "metadata.csv")
        rows: Dict[str, str] = {}
        if os.path.exists(meta):
            with open(meta, encoding="utf8") as f:
                for line in f.read().split("\n"):
                    if line.strip():
                        k, _, v = line.partition("|")
                        rows[k] = v
        stems = {os.path.splitext(k)[0] for k in rows}
        updated = added = 0
        auto = 0
        for item in lines:
            text = str(item.get("text", "")).strip()
            name = str(item.get("name") or "").strip()
            if not name:
                while f"line_{auto}" in stems:
                    auto += 1
                name = f"line_{auto}.wav"
                stems.add(f"line_{auto}")
            key = name if name in rows else next(
                (k for k in rows
                 if os.path.splitext(k)[0] == os.path.splitext(name)[0]), name)
            if key in rows:
                updated += 1
            else:
                added += 1
                stems.add(os.path.splitext(key)[0])
            rows[key] = text
        os.makedirs(dataset_path, exist_ok=True)
        with open(meta, "w", encoding="utf8") as f:
            f.write("\n".join(f"{k}|{v}" for k, v in rows.items()))
        return {"ok": True, "updated": updated, "added": added}

    def _delete_record(self, dataset_path: str, name: str) -> Dict:
        """Remove a record's metadata line (reference explorer line delete,
        javascript/script.js:531-545 — the wav stays on disk and shows under
        'untranscribed')."""
        meta = os.path.join(dataset_path, "metadata.csv")
        if not os.path.exists(meta):
            return {"ok": False, "error": "no metadata.csv"}
        stem = os.path.splitext(os.path.basename(name))[0]
        rows, removed = [], False
        with open(meta, encoding="utf8") as f:
            for line in f.read().split("\n"):
                if not line.strip():
                    continue
                k = line.split("|")[0]
                if k == name or os.path.splitext(k)[0] == stem:
                    removed = True
                    continue
                rows.append(line)
        if removed:
            with open(meta, "w", encoding="utf8") as f:
                f.write("\n".join(rows))
        return {"ok": removed}

    # -------------- dataset metadata / lifecycle (reference parity) --------

    @staticmethod
    def _compose_voice_id(game_code: str, voice_id: str) -> str:
        """``<gameIdCode>_<voiceId>`` lowercased with spaces collapsed
        (reference javascript/script.js:1320-1331)."""
        code = game_code.strip().lower().replace(" ", "_")
        vid = voice_id.strip().lower().replace(" ", "_")
        return f"{code}_{vid}" if code else vid

    def _dataset_metadata(self, body: Dict) -> Dict:
        """Read or write ``dataset_metadata.json`` in the reference schema
        (javascript/script.js:1229-1244): top-level author/license/lang/
        modelVersion plus games[0]{gameId, voiceId, voiceName, gender}."""
        ds = body["path"]
        p = os.path.join(ds, "dataset_metadata.json")
        meta: Dict = {}
        if os.path.exists(p):
            try:
                with open(p, encoding="utf8") as f:
                    meta = json.load(f)
            except (json.JSONDecodeError, OSError):
                meta = {}
        upd = body.get("set")
        if isinstance(upd, dict):
            meta.setdefault("version", "3.0")
            meta.setdefault("modelType", "xVAPitch")
            meta.setdefault("games", [{}])
            for k in ("author", "license", "lang", "modelVersion"):
                if k in upd:
                    meta[k] = (str(upd[k]).strip().lower() if k == "lang"
                               else upd[k])
            game = meta["games"][0] if meta["games"] else {}
            for k in ("gameId", "voiceId", "voiceName", "gender"):
                if k in upd:
                    game[k] = (upd[k].strip().lower()
                               if k == "gameId" else upd[k])
            if "voiceId" not in game:
                game["voiceId"] = self._compose_voice_id(
                    upd.get("gameIdCode", ""), os.path.basename(ds))
            meta["games"] = [game] + list(meta.get("games", [])[1:])
            os.makedirs(ds, exist_ok=True)
            with open(p, "w", encoding="utf8") as f:
                json.dump(meta, f, indent=4)
        return {"metadata": meta, "exists": os.path.exists(p)}

    def _new_dataset(self, body: Dict) -> Dict:
        """Create ``<root>/<gameIdCode>_<voiceId>/wavs`` + the metadata files
        (reference javascript/script.js:1222-1244)."""
        root = body["datasets_root"]
        vid = self._compose_voice_id(body.get("gameIdCode", ""),
                                     body.get("voiceId")
                                     or body.get("voiceName", "voice"))
        ds = os.path.join(root, vid)
        if os.path.exists(ds):
            return {"ok": False, "error": f"dataset {vid} already exists"}
        os.makedirs(os.path.join(ds, "wavs"))
        open(os.path.join(ds, "metadata.csv"), "w").close()
        self._dataset_metadata({"path": ds, "set": {
            "author": body.get("author", ""),
            "license": body.get("license", ""),
            "lang": body.get("lang", "en"),
            "modelVersion": body.get("modelVersion", "3.0"),
            "gameId": body.get("gameId", "other"),
            "voiceId": vid,
            "voiceName": body.get("voiceName", vid),
            "gender": body.get("gender", "other"),
        }})
        return {"ok": True, "path": ds, "voiceId": vid}

    def _delete_dataset(self, ds: str) -> Dict:
        """Delete a whole dataset folder (reference btn_deletedataset,
        javascript/script.js). Refuses paths that don't look like datasets."""
        import shutil

        looks_like = (os.path.exists(os.path.join(ds, "metadata.csv"))
                      or os.path.exists(os.path.join(ds,
                                                     "dataset_metadata.json")))
        if not looks_like:
            return {"ok": False,
                    "error": "not a dataset (no metadata.csv / "
                             "dataset_metadata.json)"}
        shutil.rmtree(ds)
        return {"ok": True}

    def _remove_duplicates(self, ds: str) -> Dict:
        """Remove every record whose wav name appears more than once — lines
        AND wav files, matching the reference's remove-all-duplicates button
        (javascript/script.js:1268-1305)."""
        meta = os.path.join(ds, "metadata.csv")
        if not os.path.exists(meta):
            return {"ok": False, "error": "no metadata.csv"}
        with open(meta, encoding="utf8") as f:
            rows = [ln for ln in f.read().split("\n") if ln.strip()]
        counts: Dict[str, int] = {}
        for ln in rows:
            stem = os.path.splitext(ln.split("|")[0])[0]
            counts[stem] = counts.get(stem, 0) + 1
        dup_stems = {s for s, c in counts.items() if c > 1}
        kept = [ln for ln in rows
                if os.path.splitext(ln.split("|")[0])[0] not in dup_stems]
        removed_wavs = 0
        for stem in dup_stems:
            wav = os.path.join(ds, "wavs", stem + ".wav")
            if os.path.exists(wav):
                os.remove(wav)
                removed_wavs += 1
        with open(meta, "w", encoding="utf8") as f:
            f.write("\n".join(kept))
        return {"ok": True, "removed_lines": len(rows) - len(kept),
                "removed_wavs": removed_wavs}

    def _list_datasets(self, root: Optional[str]) -> Dict:
        """Dataset browser (reference javascript/script.js:226-233): every
        dir under the datasets path that has a metadata.csv or a wavs/
        folder, with a record count for the sidebar label."""
        root = root or self.app_settings.get("datasets_path") or ""
        out = []
        if root and os.path.isdir(root):
            for name in sorted(os.listdir(root)):
                d = os.path.join(root, name)
                meta = os.path.join(d, "metadata.csv")
                if not os.path.isdir(d):
                    continue
                if not (os.path.exists(meta)
                        or os.path.isdir(os.path.join(d, "wavs"))):
                    continue
                n = 0
                if os.path.exists(meta):
                    with open(meta, encoding="utf8", errors="replace") as f:
                        n = sum(1 for ln in f if ln.strip())
                out.append({"name": name, "path": d, "records": n})
        return {"datasets": out, "root": root}

    def _prep_text(self, body: Dict) -> Dict:
        """Preprocess-text panel (reference javascript/tools.js:788-875):
        optional metadata backup, drop blank transcripts, drop lines whose
        text contains any listed bad character, remove duplicate file names
        (all occurrences, like the reference), rewrite as name|text|text."""
        ds = body["path"]
        meta = os.path.join(ds, "metadata.csv")
        if not os.path.exists(meta):
            return {"ok": False, "error": "no metadata.csv"}
        with open(meta, encoding="utf8") as f:
            rows = [ln for ln in f.read().split("\n") if ln.strip()]
        if body.get("backup", True):
            import shutil

            shutil.copyfile(meta, os.path.join(ds, "metadata_backup.csv"))
        bad_chars = body.get("filter_chars") or []
        if isinstance(bad_chars, str):
            bad_chars = [c for c in bad_chars.split(",") if c]
        counts: Dict[str, int] = {}
        parsed = []
        for ln in rows:
            parts = ln.split("|")
            name, text = parts[0], parts[1] if len(parts) > 1 else ""
            parsed.append((name, text))
            counts[name] = counts.get(name, 0) + 1
        kept = []
        for name, text in parsed:
            if body.get("filter_blanks", True) and not text.strip():
                continue
            if bad_chars and any(c in text for c in bad_chars):
                continue
            if body.get("remove_duplicates", False) and counts[name] > 1:
                continue
            kept.append(f"{name}|{text}|{text}")
        with open(meta, "w", encoding="utf8") as f:
            f.write("\n".join(kept))
        return {"ok": True, "kept": len(kept),
                "removed": len(rows) - len(kept)}

    def _clean_data(self, ds: str) -> Dict:
        """Clean-data panel (reference javascript/tools.js:973-1008): drop
        metadata lines whose wav is missing; delete wavs absent from the
        metadata."""
        meta = os.path.join(ds, "metadata.csv")
        wav_dir = os.path.join(ds, "wavs")
        if not os.path.exists(meta):
            return {"ok": False, "error": "no metadata.csv"}
        with open(meta, encoding="utf8") as f:
            rows = [ln for ln in f.read().split("\n") if ln.strip()]
        names = set()
        kept = []
        for ln in rows:
            stem = os.path.splitext(ln.split("|")[0])[0]
            name = stem + ".wav"
            names.add(name)
            if os.path.exists(os.path.join(wav_dir, name)):
                kept.append(ln)
        if len(kept) != len(rows):
            with open(meta, "w", encoding="utf8") as f:
                f.write("\n".join(kept))
        removed_wavs = 0
        if os.path.isdir(wav_dir):
            for fname in os.listdir(wav_dir):
                if fname.endswith(".wav") and fname not in names:
                    os.remove(os.path.join(wav_dir, fname))
                    removed_wavs += 1
        return {"ok": True, "removed_lines": len(rows) - len(kept),
                "removed_wavs": removed_wavs}

    def _start_text_quality(self, body: Dict) -> Dict:
        """One-click text-quality pipeline (reference
        javascript/tools.js:883-967): a fresh ASR pass over the whole dataset
        into <ds>/.asr_reference/, then WER vs the user transcripts →
        <ds>/wer_report.txt — the file the explorer's WER column reads.
        Runs as a background task; poll /textQualityStatus."""
        ds = body["path"]
        if self._tq_task is not None and not self._tq_task.done():
            return {"ok": False, "error": "a text-quality run is in progress"}

        async def _pipeline():
            asr_dir = os.path.join(ds, ".asr_reference")
            os.makedirs(asr_dir, exist_ok=True)
            asr_meta = os.path.join(asr_dir, "metadata.csv")
            if os.path.exists(asr_meta):
                # fresh pass: score the CURRENT audio, not a stale resume
                # (reference sets ignore_existing_transcript=true)
                os.remove(asr_meta)
            tool = await self.manager.init_model("transcribe")
            await tool.run({"inPath": os.path.join(ds, "wavs"),
                            "outputDirectory": asr_dir,
                            "toolSettings": body.get("toolSettings") or {}},
                           None)
            if not os.path.exists(asr_meta):
                raise RuntimeError(
                    "transcription produced no output — configure an ASR "
                    "backend in the transcribe tool settings")
            wtool = await self.manager.init_model("wer_evaluation")
            await wtool.run({"userMetadata": meta,
                             "inputDirectory2": asr_meta,
                             "outputFile": os.path.join(ds,
                                                        "wer_report.txt")},
                            None)

        def _run_in_thread():
            # the tools are blocking CPU loops with no awaits — run the whole
            # pipeline on its own loop in a worker thread so this server's
            # event loop (every HTTP/WS endpoint + the status poll) stays
            # responsive
            asyncio.new_event_loop().run_until_complete(_pipeline())

        meta = os.path.join(ds, "metadata.csv")
        if not os.path.exists(meta):
            return {"ok": False, "error": "no metadata.csv"}
        self._tq_dataset = ds
        self._tq_task = asyncio.create_task(asyncio.to_thread(_run_in_thread))
        return {"ok": True, "started": True}

    def _text_quality_status(self, ds: str) -> Dict:
        t = self._tq_task
        status: Dict = {"running": bool(t and not t.done())}
        if status["running"] and self._tq_dataset != ds:
            # the single runner is busy with ANOTHER dataset — don't let its
            # state masquerade as this one's
            status["running"] = False
            status["busy_with"] = self._tq_dataset
        if t is not None and t.done() and self._tq_dataset == ds:
            try:
                exc = t.exception()
            except asyncio.CancelledError:
                exc = None
            if exc:
                status["error"] = str(exc)
        prog = os.path.join(ds, ".asr_reference", ".progress.txt")
        if os.path.exists(prog):
            with open(prog) as f:
                status["progress"] = f.read().strip()
        rep = os.path.join(ds, "wer_report.txt")
        if os.path.exists(rep):
            wers = []
            with open(rep, encoding="utf8") as f:
                for ln in f:
                    try:
                        wers.append(float(ln.split("|")[0]))
                    except (ValueError, IndexError):
                        pass
            if wers:
                status["mean_wer"] = round(sum(wers) / len(wers), 4)
                status["n_scored"] = len(wers)
        return status

    async def _export_voice(self, body: Dict) -> Dict:
        """Model-export flow (reference javascript/train.js:870-941): find
        ``<training_dir>/<voice>.pt``, merge ``dataset_metadata.json`` into
        the training JSON, copy both to ``out_dir`` under the final voiceId,
        and synthesize a preview wav."""
        import shutil

        ds = body["dataset_path"]
        voice = os.path.basename(os.path.normpath(ds))
        tdir = body["training_dir"]
        out_dir = body["out_dir"]
        ckpt = os.path.join(tdir, f"{voice}.pt")
        if not os.path.exists(ckpt):
            nested = os.path.join(tdir, voice, f"{voice}.pt")
            if os.path.exists(nested):
                ckpt = nested
            else:
                return {"ok": False,
                        "error": f"no {voice}.pt under {tdir} — "
                                 "has it been trained yet?"}
        tjson = os.path.splitext(ckpt)[0] + ".json"
        training = {}
        if os.path.exists(tjson):
            with open(tjson, encoding="utf8") as f:
                training = json.load(f)
        dmeta = self._dataset_metadata({"path": ds})["metadata"]
        games = dmeta.get("games") or [{}]
        voice_id = games[0].get("voiceId") or voice
        for k in ("author", "license", "lang"):
            if k in dmeta:
                training[k] = dmeta[k]
        tgames = training.setdefault("games", [{}])
        for k in ("gameId", "voiceId", "gender", "voiceName"):
            if k in games[0]:
                tgames[0][k] = games[0][k]
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{voice_id}.json"), "w",
                  encoding="utf8") as f:
            json.dump(training, f, indent=4)
        shutil.copyfile(ckpt, os.path.join(out_dir, f"{voice_id}.pt"))
        out = {"ok": True, "voiceId": voice_id,
               "pt": os.path.join(out_dir, f"{voice_id}.pt"),
               "json": os.path.join(out_dir, f"{voice_id}.json")}
        if body.get("preview", True):
            try:
                prev = await self._export_wav({
                    "xvap_ckpt": ckpt,
                    "emb": tgames[0].get("base_speaker_emb") or None,
                    "out_path": os.path.join(out_dir, f"{voice_id}.wav"),
                    "lang": training.get("lang", "en"),
                })
                out["preview"] = prev.get("path")
            except Exception as e:  # preview failure shouldn't lose the export
                out["preview_error"] = str(e)
        return out

    async def _export_wav(self, body: Dict) -> Dict:
        """Preview synthesis + loudness normalization round trip
        (reference server.py:313-330 → infer → normalize_sync)."""
        from ..ops.loudness import normalize_ebu_r128
        from ..serve import DEFAULT_TEXT, SAMPLE_RATE, save_wav

        ckpt = body["xvap_ckpt"]
        out_path = body["out_path"]
        text = body.get("text", DEFAULT_TEXT)
        emb = body.get("emb")
        if emb is None:
            emb = self._resolve_voice_emb(ckpt)
        wav = await asyncio.to_thread(
            self._synthesize_v3, ckpt, emb, text, body.get("lang", "en")
        )
        wav = normalize_ebu_r128(wav, SAMPLE_RATE)
        save_wav(out_path, wav)
        return {"ok": True, "path": out_path}

    @staticmethod
    def _resolve_voice_emb(ckpt_path: str):
        """Find the voice's speaker embedding when the caller sends none:
        for a ``.pt``, the exported voice's metadata JSON
        (games[].base_speaker_emb, reference xva_train.py:1004-1022) or an
        emb.txt beside it (``serve.resolve_voice_emb``); for an output
        directory, its emb.txt."""
        import numpy as np

        from ..serve import resolve_voice_emb

        try:
            if ckpt_path.endswith(".pt"):
                return resolve_voice_emb(ckpt_path)
            p = os.path.join(ckpt_path, "emb.txt")
            if os.path.isdir(ckpt_path) and os.path.exists(p):
                return np.loadtxt(p, delimiter=",").astype(np.float32)
        except Exception:
            pass
        return None

    def _synthesize_v3(self, ckpt_path: str, emb, text: str, lang: str = "en"):
        """Synthesize a preview from a restored checkpoint, on the jobs'
        device. ``ckpt_path`` is either a training output dir (the newest
        ``xVAPitch_<n>.pt`` of the port's ``CheckpointManager``, its
        ``model`` state already in the port's layout) or a reference-layout
        ``.pt`` (exported voice / base checkpoint, via
        ``serve.load_xvapitch``). The architecture is the
        ``model_config.json`` in that directory (beside the ``.pt``) when
        there is one — the JAX server reads it for a directory only — else
        ``XVAPitchConfig()``. A ``.pt``'s model stays loaded for the next
        request while its file is unchanged (``serve.cached_xvapitch``); a
        directory's newest checkpoint is restored at each request, as in
        JAX."""
        from ..models.xvapitch import XVAPitchConfig
        from ..serve import cached_xvapitch, synthesize_v3
        from ..train.checkpoints import CheckpointManager

        dev = self.manager.device
        # training runs persist their architecture beside the checkpoints
        # and the export; elsewhere the shipped "big" architecture
        root = ckpt_path if os.path.isdir(ckpt_path) else os.path.dirname(ckpt_path)
        mc = XVAPitchConfig()
        mc_path = os.path.join(root, "model_config.json")
        if os.path.exists(mc_path):
            with open(mc_path) as f:
                raw = json.load(f)
            mc = XVAPitchConfig(**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in raw.items()})
        model = None
        if os.path.isfile(ckpt_path) and ckpt_path.endswith(".pt"):
            model = cached_xvapitch(ckpt_path, mc, device=dev)
        elif os.path.isdir(ckpt_path):
            ckpt = CheckpointManager(ckpt_path, prefix="xVAPitch")
            step = ckpt.latest_step()
            if step is None and ckpt.foreign_steps():
                raise RuntimeError(
                    f"{ckpt.output_dir} holds JAX orbax checkpoints "
                    f"{['xVAPitch_%d' % s for s in ckpt.foreign_steps()]} and no "
                    "checkpoint of the PyTorch port, which cannot read them; preview "
                    "them with the JAX package")
            if step is not None:
                model = _restored_xvapitch(ckpt._path(step), mc, str(dev))
        if model is None:
            raise FileNotFoundError(
                f"no loadable checkpoint at {ckpt_path} — previews must come "
                "from a restored model, not fresh params"
            )
        return synthesize_v3(model, text, emb, lang)

    def _text_to_ids(self, text: str, lang: str = "en"):
        """One tokenizer for train AND inference (data/text.v3_text_to_ids)."""
        from ..data.text import v3_text_to_ids

        return v3_text_to_ids(lang)(text)

    # ---------------- runners ----------------

    async def serve(self):
        """ws-only server (the full ws+http stack is serve_with_http)."""
        from . import ws

        await ws.serve(self.websocket_handler, "localhost", self.ws_port)
        self.logger.info(f"ws listening on :{self.ws_port}")
        await asyncio.Future()

    async def serve_with_http(self):
        """Full server: websocket (asyncio, ``app/ws.py``) + stdlib HTTP
        server in a thread, bridged into the event loop (the reference runs
        HTTPServer on its main thread — server.py:360,374). Returns after
        ``/stopServer``, with both servers closed."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from . import ws

        ws_server = await ws.serve(self.websocket_handler, "localhost", self.ws_port)

        loop = asyncio.get_running_loop()
        self._stop = loop.create_future()
        app = self

        async def _http(path, body):
            try:
                return await app.handle_http(path, body)
            except SystemExit:  # /stopServer: answered, then both servers close
                if not app._stop.done():
                    app._stop.set_result(None)
                return {"ok": True}

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                app.logger.info("http " + fmt % args)

            def _respond(self, payload: bytes, status: int = 200):
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def _handle(self):
                if self.command == "GET" and self.path in ("/", "/ui", "/index.html"):
                    page = _ui_html(app.ws_port).encode("utf8")
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(page)))
                    self.end_headers()
                    self.wfile.write(page)
                    return
                if self.command == "GET" and self.path.startswith("/audio"):
                    # per-record preview player (reference explorer plays the
                    # record's wav — javascript/script.js:243-316). Restricted
                    # to the dataset's wav dirs (no path traversal).
                    from urllib.parse import parse_qs, urlparse

                    q = parse_qs(urlparse(self.path).query)
                    ds = (q.get("path") or [""])[0]
                    name = os.path.basename((q.get("name") or [""])[0])
                    # only serve from real dataset dirs: the caller-supplied
                    # root must contain metadata.csv (every xva dataset does)
                    is_dataset = os.path.isfile(os.path.join(ds, "metadata.csv"))
                    ctypes_map = {".wav": "audio/wav", ".flac": "audio/flac",
                                  ".ogg": "audio/ogg", ".mp3": "audio/mpeg"}
                    ctype = ctypes_map.get(
                        os.path.splitext(name)[1].lower(), "application/octet-stream")
                    for sub in ("wavs", "wavs_postprocessed"):
                        p = os.path.join(ds, sub, name)
                        if name and is_dataset and os.path.isfile(p):
                            with open(p, "rb") as f:
                                raw = f.read()
                            self.send_response(200)
                            self.send_header("Content-Type", ctype)
                            self.send_header("Content-Length", str(len(raw)))
                            self.end_headers()
                            self.wfile.write(raw)
                            return
                    self._respond(b'{"error": "not found"}', 404)
                    return
                if self.path.startswith("/uploadNoiseProfile"):
                    length = int(self.headers.get("Content-Length") or 0)
                    raw = self.rfile.read(length)
                    try:
                        self._respond(json.dumps(
                            app.save_noise_profile(raw)).encode())
                    except Exception:
                        err = traceback.format_exc()
                        app.logger.error(err)
                        self._respond(json.dumps({"error": err}).encode(),
                                      500)
                    return
                if self.path.startswith("/uploadRecording"):
                    # raw wav bytes; dataset/name in the query string
                    # (mic recording straight into the dataset —
                    # reference javascript/script.js:1005-1060)
                    from urllib.parse import parse_qs, urlparse

                    q = parse_qs(urlparse(self.path).query)
                    length = int(self.headers.get("Content-Length") or 0)
                    raw = self.rfile.read(length)
                    try:
                        result = app.save_recording(
                            q["path"][0], q["name"][0], raw,
                            text=(q.get("text") or [""])[0],
                        )
                        self._respond(json.dumps(result).encode())
                    except Exception:
                        err = traceback.format_exc()
                        app.logger.error(err)
                        self._respond(json.dumps({"error": err}).encode(), 500)
                    return
                length = int(self.headers.get("Content-Length") or 0)
                body = {}
                if length:
                    try:
                        body = json.loads(self.rfile.read(length))
                    except json.JSONDecodeError:
                        body = {}
                try:
                    fut = asyncio.run_coroutine_threadsafe(_http(self.path, body), loop)
                    result = fut.result(timeout=600)
                    self._respond(json.dumps(result).encode())
                except Exception:
                    err = traceback.format_exc()
                    app.logger.error(err)
                    self._respond(json.dumps({"error": err}).encode(), 500)

            do_GET = _handle
            do_POST = _handle

        httpd = ThreadingHTTPServer(("localhost", self.http_port), Handler)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        self.logger.info(f"ws :{self.ws_port} http :{self.http_port} ready")
        try:
            await self._stop
        finally:
            # /stopServer (or the loop's end): both servers close
            await asyncio.to_thread(httpd.shutdown)
            httpd.server_close()
            # stop listening; open connections are cancelled (and closed) as
            # the loop ends
            ws_server.close()
        self.logger.info("server stopped")


def _restored_xvapitch(path: str, cfg, device: str):
    """The generator of port checkpoint ``path`` (``state["model"]``, in the
    port's layout) in eval mode on ``device``. The file is memory-mapped, so
    the discriminator's and the optimisers' tensors are never read."""
    import torch

    from ..models.xvapitch import XVAPitch

    ckpt = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    model = XVAPitch(cfg)
    model.load_state_dict(ckpt["state"]["model"], strict=True)
    return model.eval().to(device)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--http-port", type=int, default=0)
    ap.add_argument("--ws-port", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the jobs' torch device (cuda, or cpu)")
    args = ap.parse_args(argv)
    # precedence: CLI flags > ports.txt > persisted app settings > defaults
    if not (args.http_port and args.ws_port) and os.path.exists("ports.txt"):
        # ports.txt (reference server.py:126-129) fills unset CLI ports
        with open("ports.txt") as f:
            lines = f.read().split()
            if len(lines) >= 2:
                args.http_port = args.http_port or int(lines[0])
                args.ws_port = args.ws_port or int(lines[1])
    saved = load_app_settings()
    args.http_port = args.http_port or saved["http_port"]
    args.ws_port = args.ws_port or saved["ws_port"]
    server = AppServer(args.http_port, args.ws_port, device=args.device)
    asyncio.run(server.serve_with_http())


if __name__ == "__main__":
    main()
