"""Diarization DER against the recording's length, on the CPU.

Repeats the DER harness's 3- and 5-speaker specs (``chip_smoke.py``'s
``DIAR_CASES``, from ``tests/test_diarization_der.py``) 1 to N times with
``tests/formant_speech.py``'s generator, diarizes each recording with the
port (``xva_trainer_tpu_torch.tools.speaker_tools.diarize``, the speaker
encoder at full width on the CPU), and prints one JSON line a recording:
its seconds, DER and its parts, and the speakers found. With ``--jax`` it
also runs the JAX package's ``diarize`` with JAX's default (random-init)
encoder, carries those weights to the port, and says whether the two gave
the same turns.

Run: python scripts/der_by_length.py [--passes 7] [--jax]
"""
import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=7)
    ap.add_argument("--cases", default="five,three")
    ap.add_argument("--jax", action="store_true",
                    help="also run the JAX package on its default encoder's weights")
    args = ap.parse_args()

    from formant_speech import SR, build_conversation

    from chip_smoke import DIAR_CASES
    from xva_trainer_tpu_torch.models.speaker_encoder import SpeakerEncoder
    from xva_trainer_tpu_torch.tools.der import der
    from xva_trainer_tpu_torch.tools.speaker_tools import diarize

    enc, jenc, jdiarize = SpeakerEncoder(seed=0, device="cpu"), None, None
    if args.jax:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax
        import numpy as np

        from xva_trainer_tpu import native
        from xva_trainer_tpu.models.speaker_encoder import SpeakerEncoder as JaxSpeakerEncoder
        from xva_trainer_tpu.tools.speaker_tools import diarize as jdiarize
        from xva_trainer_tpu_torch.interop.convert import speaker_encoder_state_dict

        native.get_lib = lambda: None  # scipy decoding, as the port
        jenc = JaxSpeakerEncoder()
        enc = SpeakerEncoder(state_dict=speaker_encoder_state_dict(
            jax.tree_util.tree_map(np.asarray, jenc.params)), device="cpu")
        enc.pretrained = False  # JAX's default encoder is not pretrained either
    for name in args.cases.split(","):
        spec = DIAR_CASES[name]["spec"]
        for passes in range(1, args.passes + 1):
            y, ref = build_conversation(spec * passes, with_breaths=True,
                                        **DIAR_CASES[name]["kw"])
            hyp = diarize(y, SR, enc)
            line = {"case": name, "passes": passes, "seconds": len(y) / SR,
                    "der": der(ref, hyp), "speakers": len({t["speaker"] for t in hyp}),
                    "true_speakers": len({s for s, _ in spec})}
            if jenc is not None:
                jhyp = jdiarize(y, SR, jenc)
                line.update(jax_der=der(ref, jhyp), same_turns_as_jax=jhyp == hyp)
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
