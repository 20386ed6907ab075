"""Command-line trainer of the port (the reference's standalone path,
python/xvapitch/main.py + fastpitch1_1/xva_train.py __main__ harness).

Usage:
    python -m xva_trainer_tpu_torch.cli train-v3 --dataset D --output O [--lang en]
    python -m xva_trainer_tpu_torch.cli train-v2 --dataset D --output O
    python -m xva_trainer_tpu_torch.cli tts --ckpt DIR --text "..." --out out.wav
    python -m xva_trainer_tpu_torch.cli tool formatting --in D --out O
    python -m xva_trainer_tpu_torch.cli serve [--http-port 8002 --ws-port 8001]

Counterpart of ``xva_trainer_tpu/cli.py``. Every command takes ``--device``
(``cuda`` by default; ``cpu`` runs the plain PyTorch path), where the JAX
package picks its backend through ``JAX_PLATFORMS``; ``cuda`` on a host
without a card raises. ``tool`` names a tool of the port's
``TOOL_REGISTRY`` (13 of the JAX package's 16), and ``import-whisper``
waits for the transcribe tool's port.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys


def cmd_train_v3(args):
    from .data.text import v3_text_to_ids
    from .data.xva_dataset import XvaBatcher, XvaFeatureCache, get_dataset_embedding
    from .models.speaker_encoder import SpeakerEncoder
    from .train.xvapitch_trainer import XVAPitchTrainer, XvaTrainConfig

    # same tokenizer the server / cli tts use — train and inference must agree
    tp = v3_text_to_ids(args.lang)
    cache = XvaFeatureCache(args.dataset, tp, lang=args.lang, device=args.device)
    print("building feature cache...")
    cache.build(progress=lambda d, t: print(f"\r{d}/{t}", end=""))
    emb = get_dataset_embedding(args.dataset, SpeakerEncoder(device=args.device))
    batcher = XvaBatcher([cache], batch_size=args.batch_size, d_vector=emb["main"])
    cfg = XvaTrainConfig(output_dir=args.output, batch_size=args.batch_size,
                         target_bs=args.target_bs)
    trainer = XVAPitchTrainer(batcher, cfg, device=args.device)
    trainer.setup(resume=not args.no_resume)
    result = trainer.train(max_steps=args.max_steps)
    print(json.dumps(result))
    voice = os.path.basename(args.dataset.rstrip("/"))
    print("exported:", trainer.export(voice, lang=args.lang,
                                      base_emb=emb["main"],
                                      other_embs=emb["others"].tolist()))


def cmd_train_v2(args):
    from .train.pipeline import PipelineConfig, train_v2_pipeline

    cfg = PipelineConfig(
        dataset_path=args.dataset, output_path=args.output,
        batch_size=args.batch_size, target_bs=args.target_bs,
        voice_name=os.path.basename(args.dataset.rstrip("/")),
    )
    print(json.dumps(train_v2_pipeline(cfg, max_iters=args.max_steps, device=args.device)))


def cmd_tts(args):
    from .app.server import AppServer
    from .ops.loudness import normalize_ebu_r128
    from .serve import SAMPLE_RATE, save_wav

    server = AppServer(logger=_null_logger(), device=args.device)
    wav = server._synthesize_v3(args.ckpt, None, args.text)
    save_wav(args.out, normalize_ebu_r128(wav, SAMPLE_RATE))
    print("wrote", args.out)


def cmd_tool(args):
    from .tools import get_tool

    # raises a KeyError naming the tool while it is not ported
    tool = get_tool(args.tool)(device=args.device)
    data = {"inPath": args.inp, "outputDirectory": args.out}
    if args.settings:
        data["toolSettings"] = json.loads(args.settings)
    # run() (not runTask()) so failures PROPAGATE — runTask reports errors
    # to a websocket we don't have and would exit 0 on failure
    asyncio.run(tool.run(data))
    print("done")


def cmd_serve(args):
    from .app.server import AppServer

    server = AppServer(args.http_port, args.ws_port, device=args.device)
    asyncio.run(server.serve_with_http())


def _null_logger():
    import logging

    lg = logging.getLogger("xva_trainer_tpu_torch.cli")
    if not lg.handlers:
        lg.addHandler(logging.StreamHandler())
    return lg


def build_parser() -> argparse.ArgumentParser:
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default="cuda",
                     help="torch device: cuda (the default) or cpu")
    ap = argparse.ArgumentParser(prog="xva_trainer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t3 = sub.add_parser("train-v3", parents=[dev])
    t3.add_argument("--dataset", required=True)
    t3.add_argument("--output", required=True)
    t3.add_argument("--lang", default="en")
    t3.add_argument("--batch-size", type=int, default=64, dest="batch_size")
    t3.add_argument("--target-bs", type=int, default=400, dest="target_bs")
    t3.add_argument("--max-steps", type=int, default=None, dest="max_steps")
    t3.add_argument("--no-resume", action="store_true")
    t3.set_defaults(fn=cmd_train_v3)

    t2 = sub.add_parser("train-v2", parents=[dev])
    t2.add_argument("--dataset", required=True)
    t2.add_argument("--output", required=True)
    t2.add_argument("--batch-size", type=int, default=32, dest="batch_size")
    t2.add_argument("--target-bs", type=int, default=256, dest="target_bs")
    t2.add_argument("--max-steps", type=int, default=None, dest="max_steps")
    t2.set_defaults(fn=cmd_train_v2)

    ts = sub.add_parser("tts", parents=[dev])
    ts.add_argument("--ckpt", required=True)
    ts.add_argument("--text", default="This is what my voice sounds like.")
    ts.add_argument("--out", default="out.wav")
    ts.set_defaults(fn=cmd_tts)

    tl = sub.add_parser("tool", parents=[dev])
    tl.add_argument("tool")
    tl.add_argument("--in", dest="inp", required=True)
    tl.add_argument("--out", required=True)
    tl.add_argument("--settings", default=None)
    tl.set_defaults(fn=cmd_tool)

    sv = sub.add_parser("serve", parents=[dev])
    sv.add_argument("--http-port", type=int, default=8002)
    sv.add_argument("--ws-port", type=int, default=8001)
    sv.set_defaults(fn=cmd_serve)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
