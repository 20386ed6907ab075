"""End-to-end demo CLI: synthetic voice dataset → v2 pipeline → TTS wav.

Usage:
    python -m xva_trainer_tpu_torch.demo [--out DIR] [--iters N] [--cpu] [--tiny]

Counterpart of ``xva_trainer_tpu/demo.py``: builds a small sine-"voice"
dataset, runs the FastPitch stages and a few HiFi-GAN steps through
``train_v2_pipeline``, exports the xVASynth-format artifacts, then
synthesizes a sentence through the trained pair. It runs on ``cuda`` (and
raises on a host without a card) unless ``--cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np


def build_synthetic_dataset(root: str, n: int = 8) -> str:
    from .data.audio_io import save_wav

    ds = os.path.join(root, "dataset")
    os.makedirs(os.path.join(ds, "wavs"), exist_ok=True)
    rng = np.random.default_rng(0)
    lines = []
    texts = [
        "hello world", "this is a test", "the quick brown fox",
        "jumps over the lazy dog", "voice model training",
        "synthetic speech sample", "one two three four", "goodbye now",
    ]
    for i in range(n):
        dur = rng.uniform(0.8, 1.5)
        t = np.arange(int(22050 * dur)) / 22050
        f0 = 140 + 25 * (i % 4)
        vib = 1 + 0.02 * np.sin(2 * np.pi * 5 * t)
        y = 0.4 * np.sin(2 * np.pi * f0 * vib * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 2.3 * t))
        save_wav(os.path.join(ds, "wavs", f"utt{i}.wav"), y.astype(np.float32))
        lines.append(f"utt{i}.wav|{texts[i % len(texts)]}")
    with open(os.path.join(ds, "metadata.csv"), "w") as f:
        f.write("\n".join(lines))
    return ds


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--iters", type=int, default=6, help="max train iters per phase")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--tiny", action="store_true", help="tiny model dims (fast)")
    args = ap.parse_args(argv)

    from . import resolve_device

    dev = resolve_device("cpu" if args.cpu else "cuda")
    print(f"[demo] device: {dev}")
    out = args.out or tempfile.mkdtemp(prefix="xva_demo_")
    ds = build_synthetic_dataset(out)
    print(f"[demo] dataset: {ds}")

    from .models.fastpitch import FastPitchConfig
    from .models.hifigan.models import HifiganConfig
    from .train.pipeline import PipelineConfig, V2InferenceModel, train_v2_pipeline

    if args.tiny:
        model_cfg = FastPitchConfig(
            symbols_embedding_dim=64, in_fft_n_layers=1, out_fft_n_layers=1,
            in_fft_d_head=32, out_fft_d_head=32, in_fft_filter_size=64,
            out_fft_filter_size=64, predictor_filter_size=32,
        )
        gen_cfg = HifiganConfig(
            upsample_initial_channel=32, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 3),),
        )
    else:
        model_cfg, gen_cfg = FastPitchConfig(), HifiganConfig()

    cfg = PipelineConfig(
        dataset_path=ds,
        output_path=os.path.join(out, "training"),
        batch_size=4,
        target_bs=4,
        max_fp_epochs=max(1, args.iters // 2),
        max_hifi_epochs=max(1, args.iters // 2),
        voice_name="demovoice",
    )
    result = train_v2_pipeline(cfg, model_cfg, gen_cfg, max_iters=args.iters, device=dev)
    print(f"[demo] training result: {result}")
    for p in result["exports"]:
        print(f"[demo] export: {p} ({os.path.getsize(p)} bytes)")

    # inference through the trained pair, restored from their checkpoints
    from .data.dataset import BucketBatcher, FeatureCache
    from .data.text.processor import TextProcessor
    from .train.fastpitch_trainer import FastPitchTrainConfig, FastPitchTrainer
    from .train.hifigan_trainer import HifiganTrainConfig, HifiganTrainer

    tp = TextProcessor()
    cache = FeatureCache(ds, tp.encode, device=dev)
    fp = FastPitchTrainer(
        cache, FastPitchTrainConfig(output_dir=cfg.output_path, batch_size=4,
                                    target_bs=4),
        model_cfg, device=dev,
    )
    batcher = BucketBatcher(cache, batch_size=4)
    fp.setup(batcher, resume=True)

    hifi = HifiganTrainer(
        ds, HifiganTrainConfig(output_dir=os.path.join(cfg.output_path, "hifi"),
                               batch_size=4),
        gen_cfg, device=dev,
    )
    hifi.setup(resume=True)

    infer = V2InferenceModel(fp.model, hifi.gen, mel_max_len=256)
    wav_path = os.path.join(out, "preview.wav")
    infer.export_wav("This is what my voice sounds like.", wav_path)
    print(f"[demo] synthesized: {wav_path} ({os.path.getsize(wav_path)} bytes)")
    print("[demo] OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
