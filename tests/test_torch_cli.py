"""The port's command line (``xva_trainer_tpu_torch/cli.py``) and demo
(``demo.py``) on the CPU: ``tts`` from a tiny trainer's output directory,
``import-whisper`` and ``tool transcribe`` on its file, each command's
defaults against the JAX package's parser, and the v2 demo end to end."""
import argparse
import os

import numpy as np
import pytest

from xva_trainer_tpu import cli as jax_cli
from xva_trainer_tpu_torch import cli, demo
from xva_trainer_tpu_torch.data.audio_io import save_wav

TINY = dict(n_vocab=524, big=False, upsample_initial_channel=32, resblock_kernel_sizes=(3,),
            spec_segment_size=8, text_layers=2, posterior_layers=3, flow_wn_layers=2,
            num_flows=2, sdp_flows=2, pitch_layers=1)


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """An output directory as a v3 job leaves it: the trainer's
    ``model_config.json`` and a checkpoint of its state."""
    from xva_trainer_tpu_torch.data.text import v3_text_to_ids
    from xva_trainer_tpu_torch.data.xva_dataset import XvaBatcher, XvaFeatureCache
    from xva_trainer_tpu_torch.models.xvapitch import XVAPitchConfig
    from xva_trainer_tpu_torch.train.xvapitch_trainer import XVAPitchTrainer, XvaTrainConfig

    root = tmp_path_factory.mktemp("cli")
    ds = root / "voice"
    (ds / "wavs").mkdir(parents=True)
    t = np.arange(int(22050 * 0.7)) / 22050
    for i in range(2):
        save_wav(str(ds / "wavs" / f"u{i}.wav"),
                 (0.4 * np.sin(2 * np.pi * (150 + 40 * i) * t)).astype(np.float32))
    (ds / "metadata.csv").write_text("u0.wav|short line\nu1.wav|another line")
    cache = XvaFeatureCache(str(ds), v3_text_to_ids("en"), device="cpu")
    cache.build()
    out = root / "out"
    trainer = XVAPitchTrainer(XvaBatcher([cache], batch_size=2, d_vector=np.zeros(512)),
                              XvaTrainConfig(output_dir=str(out), batch_size=2),
                              XVAPitchConfig(**TINY), device="cpu")
    trainer.ckpt.save(1, trainer.checkpoint_state(), trainer.host_state())
    return out, trainer


def test_tts_from_an_output_directory(tiny_run, tmp_path):
    from xva_trainer_tpu_torch.ops.loudness import normalize_ebu_r128
    from xva_trainer_tpu_torch.serve import save_wav as serve_save, synthesize_v3

    out, trainer = tiny_run
    wav = tmp_path / "tts.wav"
    cli.main(["tts", "--ckpt", str(out), "--text", "hello there", "--out", str(wav),
              "--device", "cpu"])
    want = tmp_path / "want.wav"
    trainer.model.eval()
    serve_save(str(want), normalize_ebu_r128(synthesize_v3(trainer.model, "hello there", None),
                                             22050))
    assert wav.read_bytes() == want.read_bytes()
    # cuda by default: this host has no card
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["tts", "--ckpt", str(out), "--out", str(tmp_path / "x.wav")])


def test_tool_not_ported(tmp_path):
    """Every tool is ported: ``import-whisper`` converts a whisper ``.pt``
    into ``whisper.pt``, and ``tool transcribe`` runs on it on the device
    it is given; an unknown tool still raises, and the default device is
    ``cuda``, which this host has not."""
    import dataclasses
    import json

    import torch

    from xva_trainer_tpu_torch.models.whisper import Whisper, WhisperConfig

    cfg = WhisperConfig(n_vocab=1000, n_audio_state=32, n_audio_head=2, n_audio_layer=1,
                        n_text_state=32, n_text_head=2, n_text_layer=1)
    torch.manual_seed(0)
    src = tmp_path / "tiny.pt"
    torch.save({"dims": dataclasses.asdict(cfg), "model_state_dict": Whisper(cfg).state_dict()},
               src)
    cli.main(["import-whisper", str(src), "--out", str(tmp_path / "asr")])
    ckpt = tmp_path / "asr" / "whisper.pt"
    assert sorted(os.listdir(tmp_path / "asr")) == ["whisper.pt"]
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    for i in range(2):
        save_wav(str(wavs / f"w{i}.wav"),
                 (0.3 * np.sin(np.arange(11025) * (0.05 + 0.02 * i))).astype(np.float32))
    cli.main(["tool", "transcribe", "--in", str(wavs), "--out", str(tmp_path / "o"),
              "--settings", json.dumps({"modelPath": str(ckpt)}), "--device", "cpu"])
    rows = (tmp_path / "o" / "metadata.csv").read_text().split("\n")
    assert [r.split("|")[0] for r in rows] == ["w0.wav", "w1.wav"]
    assert all(r.split("|")[1].split() for r in rows)  # token ids: no tokenizer assets
    with pytest.raises(KeyError, match="unknown tool"):
        cli.main(["tool", "nope", "--in", "a", "--out", "b"])
    # a tool runs on the device it is given; cuda by default, which this host has not
    save_wav(str(tmp_path / "a.wav"), np.zeros(4410, np.float32), 44100)
    cli.main(["tool", "formatting", "--in", str(tmp_path), "--out", str(tmp_path / "f"),
              "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "f")) == [".progress.txt", "a.wav"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["tool", "formatting", "--in", str(tmp_path), "--out", str(tmp_path / "f")])


ARGVS = [
    ["train-v3", "--dataset", "D", "--output", "O"],
    ["train-v3", "--dataset", "D", "--output", "O", "--lang", "fr", "--batch-size", "8",
     "--target-bs", "32", "--max-steps", "3", "--no-resume"],
    ["train-v2", "--dataset", "D", "--output", "O"],
    ["train-v2", "--dataset", "D", "--output", "O", "--batch-size", "4", "--max-steps", "2"],
    ["tts", "--ckpt", "C"],
    ["tts", "--ckpt", "C", "--text", "hi", "--out", "o.wav"],
    ["tool", "formatting", "--in", "I", "--out", "O"],
    ["tool", "formatting", "--in", "I", "--out", "O", "--settings", "{}"],
    ["import-whisper", "S", "--out", "O"],
    ["serve"],
    ["serve", "--http-port", "9002", "--ws-port", "9001"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: "_".join(a[:1] + [str(len(a))]))
def test_arguments_match_the_jax_parser(argv, monkeypatch):
    seen = {}

    def capture(args):
        seen["jax"] = vars(args)

    for name in ("cmd_train_v3", "cmd_train_v2", "cmd_tts", "cmd_tool", "cmd_import_whisper",
                 "cmd_serve"):
        monkeypatch.setattr(jax_cli, name, capture)
    jax_cli.main(argv)
    mine = vars(cli.build_parser().parse_args(argv))
    theirs = seen["jax"]
    on_host = argv[0] == "import-whisper"  # a file conversion: no --device
    assert mine.pop("device", None) == (None if on_host else "cuda")
    theirs.pop("fn")
    assert mine.pop("fn").__name__ == "cmd_" + argv[0].replace("-", "_")
    assert mine == theirs
    if not on_host:
        assert isinstance(cli.build_parser().parse_args(argv + ["--device", "cpu"]),
                          argparse.Namespace)


def test_demo_on_the_cpu(tmp_path, capsys):
    assert demo.main(["--cpu", "--tiny", "--iters", "2", "--out", str(tmp_path)]) == 0
    training = tmp_path / "training"
    assert os.path.getsize(training / "demovoice.pt") > 0
    assert os.path.getsize(training / "demovoice.hg.pt") > 0
    from scipy.io import wavfile

    sr, pcm = wavfile.read(tmp_path / "preview.wav")
    assert sr == 22050 and len(pcm) > 0 and len(pcm) % 256 == 0
    assert "[demo] OK" in capsys.readouterr().out


def test_demo_needs_a_card_without_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo.main(["--tiny", "--out", str(tmp_path)])
    assert not os.listdir(tmp_path)
