"""The port's v2 pipeline: the OOM batch-size retreat and the propagation
of other errors, mirroring tests/test_pipeline.py with the port's own OOM
error, and a ``force_stage=5`` run end to end on the CPU at reduced sizes
(4 seeded clips, a narrow generator, the discriminator cut to periods
(2, 3) and 2 scales, 2 steps) to the ``.hg.pt`` export."""
import gc
import os
import weakref

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from xva_trainer_tpu_torch.interop.pretrained import load_hifigan_generator
from xva_trainer_tpu_torch.models.fastpitch import FastPitchConfig
from xva_trainer_tpu_torch.models.hifigan import Generator, HifiganConfig, HifiganDiscriminator
from xva_trainer_tpu_torch.train import hifigan_trainer as pht
from xva_trainer_tpu_torch.train import pipeline as P

GEN_CFG = HifiganConfig(upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                        resblock_dilation_sizes=((1, 3, 5),))


class _Held:
    """Stands in for a failed attempt's trainers."""


@pytest.mark.parametrize("error", [
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    RuntimeError("RESOURCE_EXHAUSTED: out of memory on HBM")], ids=["torch_oom", "xla_oom"])
def test_oom_batch_retreat(monkeypatch, error):
    """An out-of-memory failure restarts the pipeline with the batch size
    less 3 (reference handleTrainer:131-145); what the failed attempt held
    is released before the retry starts."""
    seen, held = [], []

    def fake_inner(cfg, model_cfg, gen_cfg, max_iters, on_trainer, device):
        gc.collect()
        seen.append((cfg.batch_size, [r() is not None for r in held]))
        if len(seen) < 3:
            trainers = _Held()  # alive in this frame when the error leaves it
            held.append(weakref.ref(trainers))
            raise type(error)(str(error))  # a new error each time, as a failing step raises
        return {"ok": True, "bs": cfg.batch_size}

    monkeypatch.setattr(P, "_train_v2_pipeline", fake_inner)
    cfg = P.PipelineConfig(dataset_path="/nonexistent", output_path="/tmp/x", batch_size=16)
    out = P.train_v2_pipeline(cfg, device="cpu")
    assert [bs for bs, _ in seen] == [16, 13, 10]
    assert all(not any(alive) for _, alive in seen)
    assert out == {"ok": True, "bs": 10}


@pytest.mark.parametrize("batch,attempts", [(5, 2), (40, 9)], ids=["batch_floor", "eight_retries"])
def test_oom_retreat_stops(monkeypatch, batch, attempts):
    """The retreat stops at a batch of 3 or less and after 8 retries: the
    OOM then propagates."""
    seen = []

    def fake_inner(cfg, *a):
        seen.append(cfg.batch_size)
        raise torch.cuda.OutOfMemoryError("CUDA out of memory.")

    monkeypatch.setattr(P, "_train_v2_pipeline", fake_inner)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        P.train_v2_pipeline(P.PipelineConfig(batch_size=batch), device="cpu")
    assert seen == [batch - 3 * i for i in range(attempts)]


def test_non_oom_error_propagates(monkeypatch):
    def fake_inner(*a, **k):
        raise ValueError("unrelated failure")

    monkeypatch.setattr(P, "_train_v2_pipeline", fake_inner)
    with pytest.raises(ValueError, match="unrelated"):
        P.train_v2_pipeline(P.PipelineConfig(dataset_path="/nonexistent"), device="cpu")


def test_force_stage_5_to_the_export(tmp_path, monkeypatch):
    """``force_stage`` 5 skips FastPitch: the v2 cache, then the HiFi-GAN
    trainer (batch min(16, 2), no warm start) for ``max_iters`` 2, an
    epoch's checkpoint, and the ``.hg.pt`` export, the only path returned;
    it loads strictly. ``on_trainer`` sees both trainers."""
    monkeypatch.setattr(pht, "HifiganDiscriminator", lambda: HifiganDiscriminator((2, 3), 2))
    rng = np.random.default_rng(0)
    ds = tmp_path / "ds"
    os.makedirs(ds / "wavs")
    with open(ds / "metadata.csv", "w") as f:
        for i, n in enumerate((12000, 15000, 9000, 20000)):
            t = np.arange(n) / 22050.0
            y = 0.3 * np.sin(2 * np.pi * (140 + 30 * i) * t) + 0.01 * rng.standard_normal(n)
            wavfile.write(str(ds / "wavs" / f"c{i}.wav"), 22050,
                          np.round(np.clip(y, -1, 1) * 32767).astype(np.int16))
            f.write(f"c{i}.wav|The quick brown fox number {i}.\n")
    fp_cfg = FastPitchConfig(symbols_embedding_dim=64, in_fft_n_layers=2, out_fft_n_layers=2,
                             in_fft_d_head=32, out_fft_d_head=32, in_fft_filter_size=128,
                             out_fft_filter_size=128, predictor_filter_size=128)
    trainers = []
    cfg = P.PipelineConfig(dataset_path=str(ds), output_path=str(tmp_path / "out"),
                           batch_size=2, force_stage=5, max_hifi_epochs=1, voice_name="v",
                           use_amp=False)
    res = P.train_v2_pipeline(cfg, fp_cfg, GEN_CFG, max_iters=2, on_trainer=trainers.append,
                              device="cpu")
    hg = str(tmp_path / "out" / "v.hg.pt")
    assert res["exports"] == [hg] and res["fastpitch"] == {"skipped": True}
    assert res["hifigan"]["total_iter"] == 2 and res["hifigan"]["epoch"] == 1
    assert [type(t).__name__ for t in trainers] == ["FastPitchTrainer", "HifiganTrainer"]
    hifi = trainers[1]
    assert hifi.cfg.batch_size == 2 and hifi.cfg.output_dir == str(tmp_path / "out" / "hifi")
    assert hifi.ckpt.latest_step() == 2
    sd = torch.load(hg, weights_only=True)
    assert list(sd) == ["generator"]
    assert all(v.dtype == torch.float32 for v in sd["generator"].values())
    gen = Generator(GEN_CFG)
    load_hifigan_generator(hg, gen)
    mel = torch.from_numpy(rng.standard_normal((1, 80, 8)).astype(np.float32))
    with torch.no_grad():
        assert torch.allclose(gen(mel), hifi.gen(mel), rtol=0, atol=1e-6)
