"""WER evaluation (reference python/wer_evaluation/model.py).

Counterpart of the WER half of ``xva_trainer_tpu/tools/text_tools.py``;
``TranscribeTool``, ``MakeSrtTool`` and ``SourceSeparationTool`` need the
whisper, wav2vec2 and enhancer models, which the port does not have yet.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .base import BaseTool


def wer(reference: str, hypothesis: str) -> float:
    """Word error rate via Levenshtein distance (native jiwer replacement,
    reference wer_evaluation/model.py:36-85)."""
    r = reference.lower().split()
    h = hypothesis.lower().split()
    if not r:
        return 0.0 if not h else 1.0
    d = np.zeros((len(r) + 1, len(h) + 1), np.int32)
    d[:, 0] = np.arange(len(r) + 1)
    d[0, :] = np.arange(len(h) + 1)
    for i in range(1, len(r) + 1):
        for j in range(1, len(h) + 1):
            cost = 0 if r[i - 1] == h[j - 1] else 1
            d[i, j] = min(d[i - 1, j] + 1, d[i, j - 1] + 1, d[i - 1, j - 1] + cost)
    return float(d[len(r), len(h)]) / len(r)


class WerEvaluationTool(BaseTool):
    """'wer_evaluation': WER between user metadata.csv and ASR metadata.csv,
    sorted report (reference wer_evaluation/model.py:36-85)."""

    async def run(self, data: Dict, websocket=None):
        user_csv = data.get("userMetadata") or data["inPath"]
        asr_csv = data.get("asrMetadata") or data["inputDirectory2"]
        out_path = data.get("outputFile") or os.path.join(
            os.path.dirname(user_csv), "wer_report.txt"
        )

        def read_csv(p):
            out = {}
            with open(p, encoding="utf-8") as f:
                for line in f:
                    if "|" in line:
                        k, v = line.strip().split("|", 1)
                        out[os.path.splitext(k)[0]] = v.split("|")[0]
            return out

        user = read_csv(user_csv)
        hyp = read_csv(asr_csv)
        rows = []
        for k, ref_text in user.items():
            if k in hyp:
                rows.append((wer(ref_text, hyp[k]), k, ref_text, hyp[k]))
        rows.sort(reverse=True)
        with open(out_path, "w", encoding="utf-8") as f:
            for w, k, r, h in rows:
                f.write(f"{w:.3f} | {k} | {r} | {h}\n")
        mean_wer = float(np.mean([r[0] for r in rows])) if rows else 0.0
        await self.task_info(websocket, f"mean WER: {mean_wer:.3f} over {len(rows)} files")
        await self.done(websocket)
