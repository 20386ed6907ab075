"""The port's task server (``xva_trainer_tpu_torch/app``) held to the JAX
server (``xva_trainer_tpu/app``).

Both servers run against identical seeded fixture trees, each from its own
working directory (the settings and queue files live there); the port's is
set to the CPU with ``/setDevice``. Each endpoint's JSON replies (paths
written relative to the tree's root) and the files it leaves must be equal.
Then the websocket protocol and the queue, the device rules (recordings,
the tool registry, ``/setDevice "tpu"``), and the UI page."""
import asyncio
import io
import json
import logging
import os
import re
from logging.handlers import RotatingFileHandler

import numpy as np
import pytest
from scipy.io import wavfile

from xva_trainer_tpu import native
from xva_trainer_tpu.app import server as jax_server
from xva_trainer_tpu_torch.app import server as torch_server
from xva_trainer_tpu_torch.data.audio_io import save_wav


class FakeWS:
    def __init__(self, messages=()):
        self.sent = []
        self._messages = list(messages)

    async def send(self, msg):
        self.sent.append(msg)

    def __aiter__(self):
        return self

    async def __anext__(self):
        if not self._messages:
            raise StopAsyncIteration
        return self._messages.pop(0)


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def make_tree(root):
    """A seeded datasets tree: voices with transcripts, a missing wav, an
    untranscribed wav, duplicate lines, a WER report, dataset metadata, and
    a training output directory."""
    rng = np.random.default_rng(7)
    data = root / "datasets"
    for name, n in (("game_voice", 4), ("other_voice", 3)):
        ds = data / name
        (ds / "wavs").mkdir(parents=True)
        for i in range(n):
            y = 0.3 * np.sin(np.arange(int(22050 * rng.uniform(0.3, 0.9))) * rng.uniform(0.02, 0.1))
            save_wav(str(ds / "wavs" / f"{name}_{i}.wav"), y.astype(np.float32))
        rows = [f"{name}_{i}.wav|line number {i} of {name}" for i in range(n - 1)]
        rows += [f"{name}_0.wav|a duplicate of the first", f"{name}_9|no wav, no extension",
                 f"{name}_1|bad char # here", f"{name}_8.wav|"]
        (ds / "metadata.csv").write_text("\n".join(rows), encoding="utf8")
    (data / "game_voice" / "wer_report.txt").write_text(
        "0.25|game_voice_0|ref|hyp\n0.5|game_voice_1|a|b\nnot a number|x\n")
    (data / "game_voice" / "dataset_metadata.json").write_text(json.dumps(
        {"version": "3.0", "author": "someone", "lang": "en",
         "games": [{"gameId": "skyrim", "voiceId": "sk_game_voice", "gender": "female"}]}))
    (data / "not_a_dataset").mkdir()
    (data / "readme.txt").write_text("a file")
    out = root / "out"
    out.mkdir()
    (out / "graphs.json").write_text(json.dumps({"1": {"loss": [[1, 2.5], [2, 2.25]]}}))
    (out / "training.log").write_text("\n".join(f"log line {i}" for i in range(70)))


def tree_files(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            if f in ("server.log",):
                continue
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _logger(name, path):
    lg = logging.getLogger(name)
    for h in list(lg.handlers):
        lg.removeHandler(h)
        h.close()
    lg.setLevel(logging.INFO)
    h = RotatingFileHandler(str(path), maxBytes=1 << 20)
    h.setFormatter(logging.Formatter("%(message)s"))
    lg.addHandler(h)
    lg.propagate = False
    return lg


class Pair:
    """The JAX and the port server, each on its own copy of the tree."""

    def __init__(self, tmp_path, monkeypatch):
        # both packages decode with scipy
        monkeypatch.setattr(native, "get_lib", lambda: None)
        self.monkeypatch = monkeypatch
        self.roots = {"jax": tmp_path / "jax", "torch": tmp_path / "torch"}
        self.servers = {}
        for key, mod in (("jax", jax_server), ("torch", torch_server)):
            self.roots[key].mkdir()
            make_tree(self.roots[key])
            with self.cwd(key):
                lg = _logger(f"test_torch_app_server.{key}", self.roots[key] / "server.log")
                self.servers[key] = mod.AppServer(logger=lg)
        run(self.servers["torch"].handle_http("/setDevice", {"device": "cpu"}))
        assert self.servers["torch"].manager.device == "cpu"

    def cwd(self, key):
        root = self.roots[key]

        class _Cwd:
            def __enter__(s):
                s.old = os.getcwd()
                os.chdir(root)

            def __exit__(s, *exc):
                os.chdir(s.old)

        return _Cwd()

    def norm(self, key, value):
        """Paths under the tree written relative to its root."""
        text = json.dumps(value, sort_keys=True).replace(str(self.roots[key]), "<root>")
        return json.loads(text)

    def call(self, path, body):
        """Each server's reply to ``path`` with ``body`` (paths in the body
        given relative to the root)."""
        out = {}
        for key, srv in self.servers.items():
            b = json.loads(json.dumps(body).replace("<root>", str(self.roots[key])))
            with self.cwd(key):
                out[key] = self.norm(key, run(srv.handle_http(path, b)))
        return out

    def files(self):
        return {k: tree_files(r) for k, r in self.roots.items()}


@pytest.fixture
def pair(tmp_path, monkeypatch):
    return Pair(tmp_path, monkeypatch)


V = "<root>/datasets/game_voice"
ENDPOINT_CASES = {
    "checkReady": [("/checkReady", {})],
    "getAudioLengthOfDir": [("/getAudioLengthOfDir", {"directory": V + "/wavs"})],
    "datasetInfo": [("/datasetInfo", {"path": V}),
                    ("/datasetInfo", {"path": "<root>/datasets/other_voice"})],
    "updateTranscript": [("/updateTranscript", {"path": V, "name": "game_voice_1.wav",
                                                "text": "edited"}),
                         ("/updateTranscript", {"path": V, "name": "brand_new.wav",
                                                "text": "appended"}),
                         ("/datasetInfo", {"path": V})],
    "deleteRecord": [("/deleteRecord", {"path": V, "name": "game_voice_2.wav"}),
                     ("/deleteRecord", {"path": V, "name": "game_voice_2.wav"}),
                     ("/deleteRecord", {"path": "<root>/out", "name": "x.wav"})],
    "importMetadata": [("/importMetadata", {"path": V, "lines": [
        {"name": "game_voice_0.wav", "text": "new text"}, {"name": "c.wav", "text": "fresh"},
        {"text": "typed line one"}, {"text": "typed line two"}]})],
    "datasetMetadata": [("/datasetMetadata", {"path": V}),
                        ("/datasetMetadata", {"path": V, "set": {
                            "author": "me", "lang": " FR ", "gameId": " Fallout4 ",
                            "voiceName": "Voice"}}),
                        ("/datasetMetadata", {"path": "<root>/datasets/other_voice", "set": {
                            "gameIdCode": "f4", "license": "cc"}})],
    "newDataset": [("/newDataset", {"datasets_root": "<root>/datasets", "gameIdCode": "F4",
                                    "voiceId": "New Voice", "author": "me", "lang": "de"}),
                   ("/newDataset", {"datasets_root": "<root>/datasets", "gameIdCode": "F4",
                                    "voiceId": "New Voice"})],
    "deleteDataset": [("/deleteDataset", {"path": "<root>/datasets/not_a_dataset"}),
                      ("/deleteDataset", {"path": "<root>/datasets/other_voice"})],
    "removeDuplicates": [("/removeDuplicates", {"path": V}),
                         ("/removeDuplicates", {"path": "<root>/out"})],
    "listDatasets": [("/listDatasets", {"path": "<root>/datasets"}),
                     ("/listDatasets", {})],
    "prepText": [("/prepText", {"path": V, "filter_chars": "#,@", "remove_duplicates": True}),
                 ("/prepText", {"path": "<root>/datasets/other_voice", "backup": False,
                                "filter_blanks": False})],
    "cleanData": [("/cleanData", {"path": V}), ("/cleanData", {"path": "<root>/out"})],
    "graphs": [("/graphs", {"dir": "<root>/out"}), ("/graphs", {"dir": "<root>/datasets"})],
    "trainingLog": [("/trainingLog", {"dir": "<root>/out", "tail": 5}),
                    ("/trainingLog", {"dir": "<root>/out"}),
                    ("/trainingLog", {"dir": "<root>/datasets"})],
    "queue": [("/queue", {})],
    "updateQueueItem_move": [("/updateQueueItem", {"index": 2, "move": 0}),
                             ("/updateQueueItem", {"index": 0, "move": 5}),
                             ("/queue", {})],
    "updateQueueItem_duplicate": [("/updateQueueItem", {"index": 1, "duplicate": True}),
                                  ("/queue", {})],
    "updateQueueItem_remove": [("/updateQueueItem", {"index": 0, "remove": True}),
                               ("/updateQueueItem", {"index": 9, "remove": True}),
                               ("/queue", {})],
    "updateQueueItem_config": [("/updateQueueItem", {"index": 1, "config": {
        "batch_size": 8, "force_stage": 5}}), ("/queue", {})],
    "serverLog": [("/serverLog", {"tail": 3})],
    "unknown_path": [("/noSuchEndpoint", {})],
}


@pytest.mark.parametrize("case", sorted(ENDPOINT_CASES))
def test_endpoint_parity(pair, case):
    if case.startswith("updateQueueItem") or case == "queue":
        for key, srv in pair.servers.items():
            srv.training.queue = [{"dataset_path": f"/d{i}"} for i in range(3)]
            srv.training.queue_index = 1
    if case == "serverLog":
        for srv in pair.servers.values():
            srv.logger.info("hello from the app logger")
    for path, body in ENDPOINT_CASES[case]:
        replies = pair.call(path, body)
        assert replies["torch"] == replies["jax"], (path, body)
    files = pair.files()
    assert files["torch"] == files["jax"]


def test_app_settings_parity(pair):
    """/appSettings set, reset and a restart's read-back: equal but for the
    device default, ``cuda`` in the port where JAX has ``tpu``."""
    def both(body):
        r = pair.call("/appSettings", body)
        assert r["torch"]["settings"].pop("device") == "cuda"
        assert r["jax"]["settings"].pop("device") == "tpu"
        assert r["torch"] == r["jax"], body
        return r["torch"]

    assert both({})["settings"]["theme"] == "dark"
    s = both({"set": {"theme": "light", "datasets_path": "/data/voices", "http_port": 9102,
                      "unknown_key": "ignored"}})["settings"]
    assert s["theme"] == "light" and "unknown_key" not in s
    # a restart reads the file back
    for key, mod in (("jax", jax_server), ("torch", torch_server)):
        with pair.cwd(key):
            pair.servers[key] = mod.AppServer(logger=pair.servers[key].logger)
    assert both({})["settings"]["http_port"] == 9102
    assert both({"reset": True})["settings"]["theme"] == "dark"
    files = pair.files()
    saved = {k: json.loads(v["app_settings.json"]) for k, v in files.items()}
    assert saved["torch"].pop("device") == "cuda" and saved["jax"].pop("device") == "tpu"
    assert saved["torch"] == saved["jax"]


def test_device_rules(pair):
    srv = pair.servers["torch"]
    # JAX's persisted "tpu", and a card this host does not have, are refused
    for device in ("tpu", "cuda"):
        with pytest.raises(RuntimeError):
            run(srv.handle_http("/setDevice", {"device": device}))
        assert srv.manager.device == "cpu"
    # the settings' device is applied, and refused, the same way
    with pair.cwd("torch"), pytest.raises(RuntimeError):
        run(srv.handle_http("/appSettings", {"set": {"device": "tpu"}}))
    assert srv.manager.device == "cpu"
    # a fresh server keeps cuda, unresolved, until asked
    assert torch_server.AppServer(logger=srv.logger).manager.device == "cuda"
    with pytest.raises(RuntimeError):
        torch_server.AppServer(logger=srv.logger, device="cuda")
    assert torch_server.APP_SETTINGS_DEFAULTS["device"] == "cuda"


def _mic_wav(sr=44100, seconds=1.0):
    t = np.arange(int(sr * seconds)) / sr
    y = (0.3 * np.sin(2 * np.pi * 440 * t) * 32767).astype(np.int16)
    buf = io.BytesIO()
    wavfile.write(buf, sr, y)
    return buf.getvalue()


def test_save_recording_parity(pair):
    raw = _mic_wav()
    out = {}
    for key, srv in pair.servers.items():
        with pair.cwd(key):
            out[key] = srv.save_recording(str(pair.roots[key] / "datasets" / "game_voice"),
                                          "take1", raw, text="a recorded line")
            out[key]["profile"] = srv.save_noise_profile(_mic_wav(22050, 0.5))["seconds"]
    assert out["torch"] == out["jax"]
    assert out["torch"]["ok"] and abs(out["torch"]["seconds"] - 1.0) < 0.05
    files = pair.files()
    assert files["torch"] == files["jax"]
    assert "datasets/game_voice/wavs/take1.wav" in files["torch"]


def test_save_recording_with_noise_removal_refused(pair):
    """A recording with ``record_noise_removal`` on is no longer refused: it
    is denoised against the saved noise profile (``NoiseRemovalTool``'s
    ``_profile`` and ``_denoise``), and the stored recording and transcript
    equal the JAX server's, sample for sample."""
    out = {}
    for key, srv in pair.servers.items():
        ds = pair.roots[key] / "datasets" / "game_voice"
        with pair.cwd(key):
            srv.save_noise_profile(_mic_wav(22050, 0.5))
            srv.app_settings["record_noise_removal"] = True
            srv.app_settings["noise_removal_strength"] = 0.4
            out[key] = srv.save_recording(str(ds), "take2", _mic_wav(), text="x")
    assert out["torch"] == out["jax"] and out["torch"]["ok"]
    files = pair.files()
    assert files["torch"] == files["jax"]
    stored = wavfile.read(io.BytesIO(files["torch"]["datasets/game_voice/wavs/take2.wav"]))[1]
    plain = wavfile.read(io.BytesIO(_mic_wav()))[1].astype(np.float32)
    assert stored.dtype == np.int16 and len(stored) == 22050
    assert np.abs(stored.astype(np.float32)).max() < 0.9 * np.abs(plain).max()  # denoised


def test_unported_tools(pair, monkeypatch):
    """No tool is left unported: the registry holds the JAX package's 16
    keys and the schema serves 16 forms equal to JAX's; a ``transcribe``
    runTask with no ASR model answers the ``tasks_error`` that names
    ``import-whisper``; ``/checkTextQuality`` with a registered ASR backend
    on each server transcribes the dataset and scores it: the same
    ``wer_report.txt`` and status as the JAX server's. An unknown key is
    still unknown."""
    from xva_trainer_tpu.tools import TOOL_REGISTRY as JAX_REGISTRY
    from xva_trainer_tpu.tools.text_tools import TranscribeTool as JaxTranscribe
    from xva_trainer_tpu_torch.tools import TOOL_REGISTRY, get_tool
    from xva_trainer_tpu_torch.tools.text_tools import TranscribeTool

    assert set(TOOL_REGISTRY) == set(JAX_REGISTRY) and len(TOOL_REGISTRY) == 16
    assert all(get_tool(k) is TOOL_REGISTRY[k] for k in TOOL_REGISTRY)
    with pytest.raises(KeyError, match="unknown tool"):
        get_tool("nope")
    srv = pair.servers["torch"]
    with pytest.raises(KeyError, match="unknown model key"):
        run(srv.handle_message(json.dumps({"model": "nope", "task": "runTask", "data": {}})))
    schema = pair.call("/toolSettingsSchema", {})
    assert len(schema["torch"]["schema"]) == 16 and schema["torch"] == schema["jax"]
    # no ASR model: the tasks_error that says how to install one
    monkeypatch.delenv("XVA_WHISPER_CKPT", raising=False)
    monkeypatch.setattr(TranscribeTool, "_asr_backend", None)
    ws = FakeWS([json.dumps({"model": "transcribe", "task": "runTask",
                             "data": {"inPath": "/x", "outputDirectory": "/y"}})])
    run(srv.websocket_handler(ws))
    events = [json.loads(m) for m in ws.sent]
    assert [e["key"] for e in events] == ["tasks_error"]
    assert "python -m xva_trainer_tpu_torch.cli import-whisper" in events[0]["data"]
    # the text-quality pass: transcribe, then WER against the user's lines
    texts = ["line number 0 of game_voice", "line number one of game voice", "a duplicate"]

    def backend(wav16k):  # by length, so that each clip gets its own line
        return texts[len(wav16k) % len(texts)]

    monkeypatch.setattr(JaxTranscribe, "_asr_backend", backend)
    monkeypatch.setattr(TranscribeTool, "_asr_backend", backend)
    status, report = {}, {}
    for key, s in pair.servers.items():
        ds = str(pair.roots[key] / "datasets" / "game_voice")

        async def text_quality():
            assert (await s.handle_http("/checkTextQuality", {"path": ds}))["started"]
            await asyncio.wait_for(asyncio.shield(s._tq_task), 60)
            return await s.handle_http("/textQualityStatus", {"path": ds})

        with pair.cwd(key):
            status[key] = pair.norm(key, asyncio.new_event_loop().run_until_complete(
                text_quality()))
        with open(os.path.join(ds, "wer_report.txt"), "rb") as f:
            report[key] = f.read()
    assert status["torch"] == status["jax"]
    assert status["torch"]["running"] is False and "error" not in status["torch"]
    assert status["torch"]["n_scored"] == 3 and status["torch"]["progress"] == "4/4"
    assert report["torch"] == report["jax"]


def test_tool_settings_schema_parity(pair):
    """``/toolSettingsSchema``: the JAX server's form of each of the 16
    tools, and no other."""
    from xva_trainer_tpu_torch.tools import TOOL_REGISTRY

    out = pair.call("/toolSettingsSchema", {})
    assert set(out["torch"]["schema"]) == set(TOOL_REGISTRY)
    assert out["torch"]["schema"] == {k: out["jax"]["schema"][k] for k in TOOL_REGISTRY}


def test_formatting_run_task_parity(pair):
    """A ``formatting`` runTask over the websocket, as the UI's tools panel
    sends it: both servers answer ``tasks_next`` and write the same files."""
    events = {}
    for key, srv in pair.servers.items():
        root = pair.roots[key]
        ws = FakeWS([json.dumps({"model": "formatting", "task": "runTask", "data": {
            "inPath": str(root / "datasets" / "other_voice" / "wavs"),
            "outputDirectory": str(root / "formatted"),
            "toolSettings": {"useMP": False, "formatting_hz": 22050}}})])
        with pair.cwd(key):
            run(srv.websocket_handler(ws))
        events[key] = [json.loads(m) for m in ws.sent]
    assert events["torch"] == events["jax"] == [{"key": "tasks_next", "data": ""}]
    files = pair.files()
    assert files["torch"] == files["jax"]
    assert sorted(f for f in files["torch"] if f.startswith("formatted/")) == [
        "formatted/.progress.txt"] + [f"formatted/other_voice_{i}.wav" for i in range(3)]


def test_speaker_search_run_task(pair):
    """A ``speaker_search`` runTask on the port's server: the manager's one
    encoder on the server's device ranks the corpus, the query's own clip
    first."""
    srv = pair.servers["torch"]
    root = pair.roots["torch"]
    query = root / "query"
    query.mkdir()
    wavs = root / "datasets" / "game_voice" / "wavs"
    (query / "q.wav").write_bytes((wavs / "game_voice_2.wav").read_bytes())
    ws = FakeWS([json.dumps({"model": "speaker_search", "task": "runTask", "data": {
        "queryPath": str(query), "corpusPath": str(wavs), "outputDirectory": str(root / "ranked")}})])
    with pair.cwd("torch"):
        run(srv.websocket_handler(ws))
    assert [json.loads(m)["key"] for m in ws.sent] == ["tasks_next"]
    ranked = sorted(f for f in os.listdir(root / "ranked") if f.endswith(".wav"))
    assert len(ranked) == 4 and ranked[0] == "00000_game_voice_2.wav"
    enc = srv.manager.models_bank["speaker_encoder"]
    assert next(enc.model.parameters()).device.type == "cpu"


def test_websocket_back_doors_and_unknown_task(pair, monkeypatch):
    async def no_sleep(_):
        return None

    monkeypatch.setattr(asyncio, "sleep", no_sleep)
    msgs = [{"model": "print", "task": "", "data": "hello"},
            {"model": "print_and_return", "task": "", "data": "echo"},
            {"model": "print_and_return", "task": "", "data": {"a": 1}},
            {"model": "gettimeddata", "task": "", "data": {}},
            {"model": "", "task": "bogus", "data": {}}]
    out = {}
    for key, srv in pair.servers.items():
        ws = FakeWS()
        out[key] = ([run(srv.handle_message(json.dumps(m), ws)) for m in msgs], ws.sent)
    assert out["torch"] == out["jax"]
    assert out["torch"][0][:2] == ["", "echo"] and out["torch"][1] == ["1", "2", "3"]
    for key, srv in pair.servers.items():
        for m in ({"model": "exit", "task": ""}, {"model": "", "task": "exit"}):
            with pytest.raises(SystemExit):
                run(srv.handle_message(json.dumps(m), FakeWS()))


def test_queue_protocol_parity(pair):
    """An empty resume's tasks_error; a start while running queues the item
    with a task_info event and persists the queue; a new session reads it."""
    out = {}
    for key, srv in pair.servers.items():
        with pair.cwd(key):
            async def go():
                ws = FakeWS()
                await srv.handle_message(json.dumps({"task": "resume", "data": {}}), ws)
                ts = srv.training
                ts.task = asyncio.ensure_future(asyncio.sleep(30))
                ts.queue, ts.queue_index = [{"dataset_path": "/a"}], 0
                for d in ("/b", "/c"):
                    await srv.handle_message(json.dumps(
                        {"task": "startTraining", "data": {"dataset_path": d}}), ws)
                await srv.handle_message(json.dumps({"task": "startTraining", "data": {}}), ws)
                running = (await srv.handle_http("/queue", {}))["running"]
                await srv.handle_message(json.dumps({"task": "pause", "data": {}}), ws)
                paused = (await srv.handle_http("/queue", {}))["paused"]
                await srv.handle_message(json.dumps({"task": "stop", "data": {}}), ws)
                await asyncio.sleep(0)
                return ws.sent, running, paused, ts.running()

            sent, running, paused, after = run(go())
            fresh = type(srv)(logger=srv.logger).training
            assert fresh.load_queue()
            out[key] = (sent, running, paused, after, fresh.queue, fresh.queue_index)
    assert out["torch"] == out["jax"]
    sent = [json.loads(m) for m in out["torch"][0]]
    assert sent[0]["key"] == "tasks_error" and "nothing to resume" in sent[0]["data"]
    assert [e["key"] for e in sent[1:]] == ["task_info", "task_info"]
    assert sent[2]["data"] == "queued (3 total): /c"
    assert out["torch"][1:4] == (True, True, False)
    assert [q["dataset_path"] for q in out["torch"][4]] == ["/a", "/b", "/c"]


def test_resource_usage_leaves_cuda_alone(pair):
    import torch

    out = run(pair.servers["torch"].handle_http("/resourceUsage", {}))
    assert {"time", "cpu_percent", "ram", "disk", "device", "pid_rss_gb"} <= set(out)
    assert out["device"]["platform"] == "uninitialized"
    assert not torch.cuda.is_initialized()


def test_ui_dom_ids_consistent():
    """The DOM-id check of tests/test_app_server.py on the port's page, and
    its device selector offers cuda and cpu."""
    html = torch_server._ui_html(9001)
    assert "const wsPort = 9001;" in html and "Dataset explorer" in html
    ids = set(re.findall(r'id="([^"]+)"', html))
    script = html[html.index("<script>"):html.index("</script>")]
    wanted = set(re.findall(r"getElementById\('([^']+)'\)", script))
    missing = wanted - ids
    assert not missing, f"JS references missing element ids: {sorted(missing)}"
    stripped = re.sub(r"'(?:\\.|[^'\\])*'|\"(?:\\.|[^\"\\])*\"|`(?:\\.|[^`\\])*`", "", script)
    stripped = re.sub(r"//[^\n]*", "", stripped)
    stripped = re.sub(r"/\*.*?\*/", "", stripped, flags=re.S)
    for o, c in (("{", "}"), ("(", ")"), ("[", "]")):
        assert stripped.count(o) == stripped.count(c), f"unbalanced {o}{c}"
    select = re.search(r'<select id="setDevice">(.*?)</select>', html, re.S).group(1)
    assert re.findall(r'<option value="([^"]+)"', select) == ["cuda", "cpu"]
    # the same ids as the JAX page
    jax_html = jax_server._ui_html(9001)
    assert ids == set(re.findall(r'id="([^"]+)"', jax_html))


def test_workers_idle_after_a_stage_cancelled_before_it_ran(pair):
    """A job stage whose task is cancelled while it waits for a worker
    thread never runs and is not counted as running."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    ts = pair.servers["torch"].training
    ran, release = [], threading.Event()

    async def go():
        asyncio.get_running_loop().set_default_executor(ThreadPoolExecutor(1))
        busy = asyncio.create_task(ts._in_thread(release.wait))
        await asyncio.sleep(0.05)
        queued = asyncio.create_task(ts._in_thread(lambda: ran.append(1)))
        await asyncio.sleep(0.05)
        assert not ts.workers_idle(timeout=0.05)
        queued.cancel()
        release.set()
        await busy
        with pytest.raises(asyncio.CancelledError):
            await queued

    run(go())
    assert ts.workers_idle(timeout=5) and ran == []
    assert [name for name, _ in ts.stage_seconds] == ["Event.wait"]
