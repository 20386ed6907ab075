"""The learning gate of the port's v3 trainer loop, on the CPU: real steps
through ``XVAPitchTrainer.train`` (the batcher, the prefetcher, the
loss-seeding pass and the shared AdamW pair) at the tiny config, as
tests/test_convergence.py::test_xvapitch_mel_converges holds the JAX step.

- Stage 1 freezes the posterior encoder and the decoder: after 3 updates
  they are bit-identical and everything else has moved.
- Then 50 updates in stage 2: the mean ``loss_mel`` of the last 10 is under
  0.95 times that of the first 10, every loss finite.

Kept apart from tests/test_torch_train_loop.py so that each file runs in
about a minute on one CPU.
"""
import os

import numpy as np
import torch

from xva_trainer_tpu_torch.data import xva_dataset as pxd
from xva_trainer_tpu_torch.data.audio_io import save_wav
from xva_trainer_tpu_torch.data.dataset import Bucket
from xva_trainer_tpu_torch.data.text import v3_text_to_ids
from xva_trainer_tpu_torch.models.xvapitch import XVAPitchConfig
from xva_trainer_tpu_torch.train.xvapitch_trainer import (POST_DEC, XVAPitchTrainer,
                                                          XvaTrainConfig)

TINY = XVAPitchConfig(n_vocab=524, big=False, upsample_initial_channel=32,
                      resblock_kernel_sizes=(3,), spec_segment_size=8, mltts_rc=False,
                      text_layers=2, posterior_layers=3, flow_wn_layers=2, num_flows=2,
                      sdp_flows=2, pitch_layers=1)


def _tone_dataset(path):
    """Two tonal clips (0.5 s at 220 and 250 Hz), as the JAX gate's batch."""
    os.makedirs(os.path.join(path, "wavs"))
    t = np.arange(int(22050 * 0.5)) / 22050
    lines = []
    for i, f0 in enumerate((220.0, 250.0)):
        save_wav(os.path.join(path, "wavs", f"t{i}.wav"),
                 (0.4 * np.sin(2 * np.pi * f0 * t)).astype(np.float32))
        lines.append(f"t{i}.wav|a tone number {i}\n")
    with open(os.path.join(path, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("".join(lines))
    cache = pxd.XvaFeatureCache(path, v3_text_to_ids("en"), device="cpu")
    cache.build()
    return cache


def _params(module):
    return {k: v.detach().clone() for k, v in module.named_parameters()}


def test_loop_learns_and_stage_1_freezes(tmp_path):
    cache = _tone_dataset(str(tmp_path / "en_tones"))
    dvec = (np.random.default_rng(0).standard_normal(512) * 0.1).astype(np.float32)
    batcher = pxd.XvaBatcher([cache], batch_size=2, d_vector=dvec, buckets=[Bucket(24, 48)])
    cfg = XvaTrainConfig(output_dir=str(tmp_path / "out"), batch_size=2, target_bs=2,
                         gen_lr=2e-3, disc_lr=2e-3, save_step=1000, use_amp=False)
    tr = XVAPitchTrainer(batcher, cfg, TINY, device="cpu")
    assert tr.gam == 1
    tr.setup(resume=False)

    metas = []
    for freeze, real in list(tr._steps.items()):
        def step(batch, gen, real=real):
            meta = real(batch, gen)
            metas.append({k: float(v) for k, v in meta.items() if v.dim() == 0})
            return meta
        tr._steps[freeze] = step

    before = _params(tr.model)
    tr.train(max_steps=3)
    after = _params(tr.model)
    assert tr.stage == 1 and tr.training_iters == 3 and len(tr.loss_sampling) == 2
    moved = {k.split(".")[0] for k in after if not torch.equal(after[k], before[k])}
    still = {k.split(".")[0] for k in after if torch.equal(after[k], before[k])}
    assert not moved & set(POST_DEC) and set(POST_DEC) <= still
    assert {"text_encoder", "flow", "duration_predictor", "pitch_predictor"} <= moved

    tr.stage = 2
    del metas[:]
    tr.train(max_steps=53)
    mels = [m["loss_mel"] for m in metas]
    assert len(mels) == 50 and all(np.isfinite(list(m.values())).all() for m in metas)
    head, tail = np.mean(mels[:10]), np.mean(mels[-10:])
    assert tail < head * 0.95, f"the mel loss did not fall: {head} -> {tail}"
    moved = {k.split(".")[0] for k, v in _params(tr.model).items() if not torch.equal(v, after[k])}
    assert set(POST_DEC) <= moved
