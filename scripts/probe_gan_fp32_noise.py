"""How far fp32 arithmetic moves one v2 HiFi-GAN step's updates, on one
NVIDIA GPU: the evidence for ``chip_smoke.py``'s ``GAN_FP32_JUMPS``,
``GAN_WEIGHT_NOISE`` and ``GAN_UPDATE_L2``.

    python3 scripts/probe_gan_fp32_noise.py

From ``chip_smoke.py``'s seeded full-width generator and discriminator
(``seeded_hifigan``) and two batches of 2 x 8 192 samples drawn by
``SegmentSampler`` from its ``fastpitch`` dataset (seeds 61 and 62), one
default-order SGD step (lr 1e-3, no AMP, TF32 off) is taken:

- in float64, by ``chip_smoke.gan_step_f64`` (a plain reference of the
  step, the mels by a float64 ``torch.fft.rfft``), on the card and, for
  the first batch, on the CPU;
- in fp32, by the port's ``make_gan_step``: on the card with cuDNN, with
  cuDNN restricted to deterministic algorithms, and with cuDNN off; on the
  CPU with oneDNN (8 threads and 1 thread) and with its native
  convolutions.

Each fp32 step's updates are held to the card's float64 step by
``chip_smoke.gan_held``: the worst bias or weight-norm scale and the
worst kernel, as ratios to ``update_mismatch``'s bar, and ``update_l2_rel`` over
each model. Then, on the CPU alone, the fp32 step again with only the real
side's mel computed otherwise (a float64 FFT rounded to fp32 in place of
the plain version) against the plain one: what a rounding-level change of
one input does. Prints one JSON line and, last, the card's name and power
limit.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from xva_trainer_tpu_torch.models.hifigan import (Generator, HifiganConfig,  # noqa: E402
                                                  HifiganDiscriminator)
from xva_trainer_tpu_torch.ops import _cuda  # noqa: E402
from xva_trainer_tpu_torch.ops.stft import MelConfig  # noqa: E402
from xva_trainer_tpu_torch.train import hifigan_trainer as pht  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_gan_fp32_noise: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    smi = cs.gpu_line()
    _cuda.build("fused_stft")
    gen0, disc0 = cs.seeded_hifigan(HifiganConfig(), HifiganDiscriminator, 60)
    old = cs.state_of(gen0, disc0)
    old_p = [cs.without_sn(x) for x in old]
    work = tempfile.mkdtemp(prefix="probe_gan_")
    try:
        cs.write_v3_dataset(os.path.join(work, "en_voice"), np.random.default_rng(30))
        ds = os.path.join(work, "v2_voice")
        cs.write_v2_dataset(ds, np.random.default_rng(40), os.path.join(work, "en_voice", "wavs"))
        segs = [torch.from_numpy(np.ascontiguousarray(
            next(pht.SegmentSampler(ds, 2, seed=s, data_mult=1).epoch()).transpose(0, 2, 1)))
            for s in (61, 62)]
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def run(seg, dv, dtype, variant, real_mel=None):
        g, d = Generator(HifiganConfig()), HifiganDiscriminator()
        g.load_state_dict(old[0])
        d.load_state_dict(old[1])
        g.to(dv, dtype)
        d.to(dv, dtype)
        torch.backends.cudnn.enabled = variant != "native"
        torch.backends.cudnn.deterministic = variant == "deterministic"
        torch.backends.mkldnn.enabled = variant != "native"
        threads = torch.get_num_threads()
        if variant == "one_thread":
            torch.set_num_threads(1)
        real = pht._hifigan_mel
        if real_mel is not None:
            pht._hifigan_mel = real_mel
        try:
            if dtype == torch.float64:
                cs.gan_step_f64(g, d, seg.to(dv, dtype))
            else:
                pht.make_gan_step(g, d, cs.Sgd(g.parameters()), cs.Sgd(d.parameters()),
                                  MelConfig(), use_amp=False)(seg.to(dv))
            if dv.type == "cuda":
                torch.cuda.synchronize()
        finally:
            pht._hifigan_mel = real
            torch.set_num_threads(threads)
            torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic = True, False
            torch.backends.mkldnn.enabled = True
        return [cs.without_sn(x) for x in cs.state_of(g, d)]

    def held(ref, new):
        h = cs.gan_held(old_p, ref, new, 0.0)
        return {"biases_and_scales_worst": h["worst"]["biases_and_scales"],
                "kernels_worst": h["worst"]["kernels"],
                "worst_ratio": max(h["worst"]["biases_and_scales"][0],
                                   h["worst"]["kernels"][0]),
                "l2_rel": h["l2_rel"]}

    out = {"gpu": smi, "batches": []}
    for i, seg in enumerate(segs):
        t0 = time.perf_counter()
        exact = run(seg, dev, torch.float64, "cudnn")
        fp32 = {"card_cudnn": run(seg, dev, torch.float32, "cudnn"),
                "card_cudnn_deterministic": run(seg, dev, torch.float32, "deterministic"),
                "card_native": run(seg, dev, torch.float32, "native"),
                "cpu_onednn": run(seg, cpu, torch.float32, "onednn"),
                "cpu_onednn_one_thread": run(seg, cpu, torch.float32, "one_thread"),
                "cpu_native": run(seg, cpu, torch.float32, "native")}
        rec = {"against_card_float64": {k: held(exact, v) for k, v in fp32.items()}}
        if i == 0:
            rec["cpu_float64_against_card_float64"] = held(exact, run(seg, cpu, torch.float64,
                                                                      "native"))
            perturbed = run(seg, cpu, torch.float32, "onednn", real_mel=lambda w, c: cs.rfft_reference(
                w.double(), c, False, 1e-9)[0].float())
            rec["real_mel_rounding_on_cpu"] = held(fp32["cpu_onednn"], perturbed)
        cpu_worst = max(rec["against_card_float64"][k]["worst_ratio"]
                        for k in ("cpu_onednn", "cpu_native"))
        rec["card_worst_over_cpu_pair_worst"] = (
            rec["against_card_float64"]["card_cudnn"]["worst_ratio"] / cpu_worst)
        rec["card_kernels_over_cpu_pair_kernels"] = (
            rec["against_card_float64"]["card_cudnn"]["kernels_worst"][0]
            / max(rec["against_card_float64"][k]["kernels_worst"][0]
                  for k in ("cpu_onednn", "cpu_native")))
        rec["seconds"] = time.perf_counter() - t0
        out["batches"].append(rec)
    print(json.dumps(out), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
