"""Diarization error rate (DER) — quality harness for the diarization tool.

The port's copy of ``xva_trainer_tpu/tools/der.py`` (numpy and scipy).

The reference shipped pyannote's pretrained pipeline and never measured it
(SURVEY §2.5); here the native VAD→embed→cluster pipeline
(speaker_tools.diarize) is held to a measurable standard: DER on synthetic
mixtures with known turns (tests/test_diarization_der.py), the same metric
the diarization literature uses (missed speech + false alarm + speaker
confusion, over total reference speech time, with an optimal speaker
mapping and a no-score collar around reference boundaries).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def _frame_labels(turns: List[Dict], n_frames: int, frame: float) -> List[set]:
    """Per-frame speaker-id sets (supports overlapped speech)."""
    lab: List[set] = [set() for _ in range(n_frames)]
    for t in turns:
        a = max(0, int(round(t["start"] / frame)))
        b = min(n_frames, int(round(t["end"] / frame)))
        for i in range(a, b):
            lab[i].add(t["speaker"])
    return lab


def der(
    reference: List[Dict],
    hypothesis: List[Dict],
    frame: float = 0.010,
    collar: float = 0.25,
) -> Dict[str, float]:
    """DER of hypothesis turns vs reference turns.

    turns: [{"start": s, "end": e, "speaker": id}]. Returns components as
    fractions of scored reference speech time:
    {"der", "missed", "false_alarm", "confusion"}.
    """
    if not reference:
        return {"der": 0.0, "missed": 0.0, "false_alarm": 0.0, "confusion": 0.0}
    end = max(t["end"] for t in reference + hypothesis)
    n = int(np.ceil(end / frame)) + 1
    ref = _frame_labels(reference, n, frame)
    hyp = _frame_labels(hypothesis, n, frame)

    # no-score collar around every reference boundary
    scored = np.ones(n, bool)
    w = int(round(collar / frame))
    for t in reference:
        for edge in (t["start"], t["end"]):
            c = int(round(edge / frame))
            scored[max(0, c - w): c + w] = False

    # optimal 1-1 speaker mapping by scored overlap (Hungarian)
    ref_ids = sorted({t["speaker"] for t in reference})
    hyp_ids = sorted({t["speaker"] for t in hypothesis})
    overlap = np.zeros((len(ref_ids), len(hyp_ids)))
    for i in range(n):
        if not scored[i]:
            continue
        for r in ref[i]:
            for h in hyp[i]:
                overlap[ref_ids.index(r), hyp_ids.index(h)] += 1
    mapping: Dict[int, int] = {}
    if overlap.size:
        from scipy.optimize import linear_sum_assignment

        ri, hi = linear_sum_assignment(-overlap)
        mapping = {hyp_ids[h]: ref_ids[r] for r, h in zip(ri, hi)}

    missed = fa = conf = total = 0
    for i in range(n):
        if not scored[i]:
            continue
        nr, nh = len(ref[i]), len(hyp[i])
        total += nr
        mapped = {mapping.get(h) for h in hyp[i]}
        correct = len(ref[i] & mapped)
        missed += max(0, nr - nh)
        fa += max(0, nh - nr)
        conf += min(nr, nh) - correct
    total = max(total, 1)
    return {
        "der": (missed + fa + conf) / total,
        "missed": missed / total,
        "false_alarm": fa / total,
        "confusion": conf / total,
    }
