"""A v3 fine-tune through the port's task server, on the CPU: ``startTraining``
over ``handle_message`` at the tiny width of ``tests/test_v3_integration.py``
with a priors dataset, two updates and a checkpoint each; the job's
artifacts; its parameters against the same trainer driven directly; the
previews of ``/exportWav`` from the restored checkpoint (bit for bit against
``serve.synthesize_v3``) and from the exported ``.pt``; ``/exportVoice``;
an orbax-only directory refused; a pause sent before the trainer exists."""
import asyncio
import json
import logging
import os

import numpy as np
import pytest
import torch

from xva_trainer_tpu_torch.app.server import AppServer
from xva_trainer_tpu_torch.data.audio_io import save_wav

TINY_MODEL = {
    "n_vocab": 524, "big": False, "upsample_initial_channel": 32,
    "resblock_kernel_sizes": [3], "spec_segment_size": 8, "mltts_rc": False,
    "text_layers": 2, "posterior_layers": 3, "flow_wn_layers": 2,
    "num_flows": 2, "sdp_flows": 2, "pitch_layers": 1,
}


def _quiet():
    lg = logging.getLogger("test_torch_server_v3")
    lg.addHandler(logging.NullHandler())
    lg.propagate = False
    return lg


def _make_ds(root, name, n=3, f0=150.0):
    ds = root / name
    (ds / "wavs").mkdir(parents=True)
    lines = []
    for i in range(n):
        t = np.arange(int(22050 * 0.7)) / 22050
        y = (0.4 * np.sin(2 * np.pi * (f0 + 30 * i) * t)).astype(np.float32)
        save_wav(str(ds / "wavs" / f"u{i}.wav"), y)
        lines.append(f"u{i}.wav|short line {i}")
    (ds / "metadata.csv").write_text("\n".join(lines))
    return ds


def _message(ft, out, priors_root):
    return {"dataset_path": str(ft), "output_path": str(out), "batch_size": 2,
            "target_bs": 4, "save_step": 1, "max_steps": 2, "use_amp": False,
            "priors_root": str(priors_root), "model_config": TINY_MODEL}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The job, started over ``handle_message`` with a pause sent at once:
    the trainer comes up paused, takes no micro-step while paused, then
    trains on ``resume``."""
    root = tmp_path_factory.mktemp("server_v3")
    ft = _make_ds(root, "en_voice")
    priors_root = root / "priors"
    priors_root.mkdir()
    _make_ds(priors_root, "en_other", f0=240.0)
    out = root / "out"
    server = AppServer(logger=_quiet())
    server.manager.set_device("cpu")
    loop = asyncio.new_event_loop()

    class WS:
        sent = []

        async def send(self, m):
            self.sent.append(json.loads(m))

    async def drive():
        ws = WS()
        msg = {"model": "xvapitch", "task": "startTraining",
               "data": _message(ft, out, priors_root)}
        await server.handle_message(json.dumps(msg), ws)
        await server.handle_message(json.dumps({"task": "pause", "data": {}}), ws)
        assert server.training.trainer is None  # still preprocessing
        for _ in range(1200):
            if server.training.trainer is not None or server.training.task.done():
                break
            await asyncio.sleep(0.1)
        trainer = server.training.trainer
        assert trainer is not None and trainer.paused, ws.sent
        await asyncio.sleep(1.5)
        paused_steps = trainer.micro_steps
        await server.handle_message(json.dumps({"task": "resume", "data": {}}), ws)
        await asyncio.wait_for(server.training.task, 600)
        return ws.sent, paused_steps

    sent, paused_steps = loop.run_until_complete(drive())
    return {"root": root, "ft": ft, "priors_root": priors_root, "out": out,
            "server": server, "loop": loop, "sent": sent, "paused_steps": paused_steps}


def test_job_trains_checkpoints_and_exports(job):
    out, ft = job["out"], job["ft"]
    assert [e["key"] for e in job["sent"]] == ["tasks_next"], job["sent"]
    assert job["paused_steps"] == 0
    trainer = job["server"].training.trainer
    assert trainer.training_iters == 2 and trainer.micro_steps > 0
    assert trainer.device.type == "cpu" and trainer.priors_batcher is not None
    assert json.loads((out / "model_config.json").read_text())["upsample_initial_channel"] == 32
    assert (out / "graphs.json").exists()
    assert sorted(p for p in os.listdir(out) if p.startswith("xVAPitch_")) == [
        "xVAPitch_1.json", "xVAPitch_1.pt", "xVAPitch_2.json", "xVAPitch_2.pt"]
    assert os.path.isdir(ft / "se_embs") and len(os.listdir(ft / "se_embs")) == 3
    assert os.path.isdir(ft / "wavs_postprocessed")
    assert (out / "en_voice.pt").exists()
    meta = json.loads((out / "en_voice.json").read_text())
    assert meta["modelType"] == "xVAPitch"
    assert len(meta["games"][0]["base_speaker_emb"]) == 512
    assert meta["lang_capabilities"] == ["en"]


def test_job_matches_the_trainer_driven_directly(job, tmp_path):
    """The same config, caches and seeds without the server: equal
    parameters and optimiser moments after the two updates."""
    from xva_trainer_tpu_torch.data.text import v3_text_to_ids
    from xva_trainer_tpu_torch.data.xva_dataset import (XvaBatcher, XvaFeatureCache,
                                                        get_dataset_embedding,
                                                        read_priors_datasets)
    from xva_trainer_tpu_torch.models.xvapitch import XVAPitchConfig
    from xva_trainer_tpu_torch.train.xvapitch_trainer import XVAPitchTrainer, XvaTrainConfig

    ft = str(job["ft"])
    tti = v3_text_to_ids("en")
    cache = XvaFeatureCache(ft, tti, lang="en", device="cpu")
    cache.build()
    emb = get_dataset_embedding(ft)  # the job's emb.txt
    batcher = XvaBatcher([cache], batch_size=2, d_vector=emb["main"])
    dirs, _ = read_priors_datasets(["en"], [str(job["priors_root"])], extract_embs=False)
    pcaches = [XvaFeatureCache(d, tti, lang="en", device="cpu") for d in dirs]
    for c in pcaches:
        c.build()
    priors = XvaBatcher(pcaches, batch_size=2, d_vector=emb["main"])
    priors.weighted_by_language = True
    cfg = XvaTrainConfig(output_dir=str(tmp_path / "direct"), batch_size=2, target_bs=4,
                         save_step=1, use_amp=False)
    mc = XVAPitchConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in TINY_MODEL.items()})
    direct = XVAPitchTrainer(batcher, cfg, mc, priors_batcher=priors, device="cpu")
    direct.setup(True, None)
    direct.train(2)
    served = job["server"].training.trainer
    for mine, theirs in ((served.model, direct.model), (served.disc, direct.disc)):
        a, b = mine.state_dict(), theirs.state_dict()
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert served.micro_steps == direct.micro_steps
    assert served.loss_sampling == direct.loss_sampling


def _restored(out):
    from xva_trainer_tpu_torch.models.xvapitch import XVAPitch, XVAPitchConfig

    mc = XVAPitchConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in TINY_MODEL.items()})
    state = torch.load(out / "xVAPitch_2.pt", map_location="cpu", weights_only=True)
    model = XVAPitch(mc)
    model.load_state_dict(state["state"]["model"], strict=True)
    return model.eval()


def test_export_wav_from_the_restored_checkpoint(job, tmp_path):
    from xva_trainer_tpu_torch.ops.loudness import normalize_ebu_r128
    from xva_trainer_tpu_torch.serve import save_wav as serve_save, synthesize_v3

    server, loop, out = job["server"], job["loop"], job["out"]
    emb = np.random.default_rng(1).standard_normal(512).astype(np.float32)
    got = tmp_path / "preview.wav"
    res = loop.run_until_complete(server.handle_http("/exportWav", {
        "xvap_ckpt": str(out), "out_path": str(got), "text": "hello there",
        "emb": emb.tolist()}))
    assert res == {"ok": True, "path": str(got)}
    want = tmp_path / "want.wav"
    model = _restored(out)
    serve_save(str(want), normalize_ebu_r128(synthesize_v3(model, "hello there", emb), 22050))
    assert got.read_bytes() == want.read_bytes()
    # the restored model is the trainer's
    for k, v in job["server"].training.trainer.model.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    # the exported .pt (its architecture from the model_config.json beside it)
    pt = tmp_path / "from_pt.wav"
    res = loop.run_until_complete(server.handle_http("/exportWav", {
        "xvap_ckpt": str(out / "en_voice.pt"), "out_path": str(pt), "text": "hello there"}))
    from scipy.io import wavfile

    sr, pcm = wavfile.read(pt)
    assert res["ok"] and sr == 22050 and len(pcm) > 1000 and len(pcm) % 256 == 0


def test_export_voice(job, tmp_path):
    server, loop, out, ft = job["server"], job["loop"], job["out"], job["ft"]
    loop.run_until_complete(server.handle_http("/datasetMetadata", {"path": str(ft), "set": {
        "author": "me", "gameIdCode": "sk", "voiceName": "Voice"}}))
    res = loop.run_until_complete(server.handle_http("/exportVoice", {
        "dataset_path": str(ft), "training_dir": str(out), "out_dir": str(tmp_path / "ex")}))
    assert res["ok"] and res["voiceId"] == "sk_en_voice", res
    assert "preview_error" not in res and os.path.getsize(res["preview"]) > 1000
    meta = json.loads(open(res["json"]).read())
    assert meta["author"] == "me" and meta["games"][0]["voiceId"] == "sk_en_voice"
    assert open(res["pt"], "rb").read() == (out / "en_voice.pt").read_bytes()


def test_orbax_only_directory_refused(job, tmp_path):
    d = tmp_path / "jax_run"
    (d / "xVAPitch_7").mkdir(parents=True)
    (d / "model_config.json").write_text(json.dumps(TINY_MODEL))
    with pytest.raises(RuntimeError, match="orbax"):
        job["loop"].run_until_complete(job["server"].handle_http("/exportWav", {
            "xvap_ckpt": str(d), "out_path": str(tmp_path / "x.wav")}))
    with pytest.raises(FileNotFoundError):
        job["loop"].run_until_complete(job["server"].handle_http("/exportWav", {
            "xvap_ckpt": str(tmp_path), "out_path": str(tmp_path / "x.wav")}))
