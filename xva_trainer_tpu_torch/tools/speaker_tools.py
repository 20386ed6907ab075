"""Speaker-embedding tools: diarization, clustering, search
(reference python/{speaker_diarization,cluster_speakers,speaker_search,
speaker_cluster_search}/model.py).

Counterpart of ``xva_trainer_tpu/tools/speaker_tools.py``. The embeddings
come from the port's ResNet-SE encoder on its device (the server's one
``speaker_encoder``); similarity search is a torch matmul on that device in
fp32; clustering is host numpy and scipy (``tools/cluster.py``, in place of
scikit-learn). Diarization is ``tools/diarize.py``'s pipeline (spectral VAD
→ fused window embeddings → eigengap auto-k Ward clustering → speaker
turns) in place of the reference's pyannote stack.
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.audio_io import resample, save_wav
from .audio_tools import decode_any, list_audio_files
from .base import BaseTool


def _get_encoder(models_manager=None, device="cuda"):
    """The manager's one ``speaker_encoder`` (the trainers' too, rebuilt on
    ``/setDevice``); without a manager, a fresh encoder on ``device``. The
    JAX package keeps a second copy in ``shared_cache``, which here would
    stay on the old device after a device change; both build the encoder
    the same way."""
    if models_manager is not None:
        return models_manager.sync_init_model("speaker_encoder")
    from ..models.speaker_encoder import SpeakerEncoder

    return SpeakerEncoder(device=device)


def embed_files(files: List[str], encoder) -> np.ndarray:
    embs = []
    for f in files:
        y, sr = decode_any(f)
        embs.append(encoder.compute_embedding(resample(y, sr, 16000)))
    return np.stack(embs) if embs else np.zeros((0, 512), np.float32)


def topk_similarity(query: np.ndarray, corpus: np.ndarray, k: int = 10,
                    device="cpu"):
    """Cosine top-k: a fp32 torch matmul on ``device`` (faiss replacement
    for these sizes). Returns (the k best corpus indices, every corpus
    row's mean similarity to the queries)."""
    q = query / np.maximum(np.linalg.norm(query, axis=-1, keepdims=True), 1e-8)
    c = corpus / np.maximum(np.linalg.norm(corpus, axis=-1, keepdims=True), 1e-8)
    qt = torch.as_tensor(np.ascontiguousarray(q, np.float32), device=device)
    ct = torch.as_tensor(np.ascontiguousarray(c, np.float32), device=device)
    sims = (ct @ qt.T).cpu().numpy()  # (N, Q)
    scores = sims.mean(axis=1)
    order = np.argsort(-scores)
    return order[:k], scores


class ClusterSpeakersTool(BaseTool):
    """'cluster_speakers': embeddings → k-means or affinity propagation →
    copy files into cluster_N folders (reference cluster_speakers/model.py:44-237)."""

    async def run(self, data: Dict, websocket=None):
        from .cluster import affinity_propagation, kmeans_labels

        in_path = data.get("inPath") or data["inputDirectory"]
        out_dir = data.get("outputDirectory") or in_path + "_clusters"
        settings = data.get("toolSettings", {})
        k = int(settings.get("numClusters", 0) or 0)
        min_cluster = int(settings.get("minClusterSize", 1))
        files = list_audio_files(in_path)
        if not files:
            await self.error(websocket, "no audio files found")
            return
        await self.task_info(websocket, f"Embedding {len(files)} files...")
        enc = _get_encoder(self.models_manager, self.device)
        embs = embed_files(files, enc)

        if k > 1:
            labels = kmeans_labels(embs, min(k, len(files)))
        else:
            labels = affinity_propagation(embs)

        counts = np.bincount(labels)
        os.makedirs(out_dir, exist_ok=True)
        for ci in range(labels.max() + 1):
            if counts[ci] < min_cluster:
                continue
            cdir = os.path.join(out_dir, f"cluster_{ci}")
            os.makedirs(cdir, exist_ok=True)
            for f, l in zip(files, labels):
                if l == ci:
                    shutil.copy2(f, cdir)
        await self.done(websocket)


class SpeakerSearchTool(BaseTool):
    """'speaker_search': rank corpus files by similarity to query voice(s),
    copy in ranked order (reference speaker_search/model.py:42-146)."""

    async def run(self, data: Dict, websocket=None):
        query_path = data.get("queryPath") or data["inPath"]
        corpus_path = data.get("corpusPath") or data["inputDirectory2"]
        out_dir = data.get("outputDirectory") or corpus_path + "_ranked"
        os.makedirs(out_dir, exist_ok=True)
        enc = _get_encoder(self.models_manager, self.device)
        q_files = list_audio_files(query_path)
        c_files = list_audio_files(corpus_path)
        q = embed_files(q_files, enc)
        c = embed_files(c_files, enc)
        order, scores = topk_similarity(q, c, k=len(c_files), device=enc.device)
        for rank, idx in enumerate(order):
            src = c_files[idx]
            shutil.copy2(
                src, os.path.join(out_dir, f"{rank:05d}_{os.path.basename(src)}")
            )
            self.write_progress(out_dir, rank + 1, len(order))
        await self.done(websocket)


class SpeakerClusterSearchTool(BaseTool):
    """'speaker_cluster_search': rank cluster subfolders by mean similarity
    (reference speaker_cluster_search/model.py:40+)."""

    async def run(self, data: Dict, websocket=None):
        query_path = data.get("queryPath") or data["inPath"]
        clusters_path = data.get("corpusPath") or data["inputDirectory2"]
        enc = _get_encoder(self.models_manager, self.device)
        q = embed_files(list_audio_files(query_path), enc)
        results = []
        subdirs = sorted(
            d for d in os.listdir(clusters_path)
            if os.path.isdir(os.path.join(clusters_path, d))
        )
        for d in subdirs:
            files = list_audio_files(os.path.join(clusters_path, d))[:10]
            if not files:
                continue
            c = embed_files(files, enc)
            _, scores = topk_similarity(q, c, device=enc.device)
            results.append((d, float(np.mean(scores))))
        results.sort(key=lambda r: -r[1])
        report = "\n".join(f"{d}: {s:.4f}" for d, s in results)
        with open(os.path.join(clusters_path, "cluster_search_results.txt"), "w") as f:
            f.write(report)
        await self.task_info(websocket, report)
        await self.done(websocket)


# ---------------- diarization ----------------


def diarize(
    y: np.ndarray,
    sr: int,
    encoder,
    num_speakers: Optional[int] = None,
    win_s: float = 1.0,
    hop_s: float = 0.25,
    min_turn_s: float = 1.0,
    speech_frac: float = 0.5,
) -> List[Dict]:
    """[{start, end, speaker}] — adaptive spectral VAD → fused window
    embeddings (speech-frame MFCC/f0 stats + deep encoder) → eigengap
    auto-k agglomerative clustering → frame-painted turns. Replaces the
    patched pyannote pipeline (reference speaker_diarization/model.py:44-434);
    the design in tools/diarize.py."""
    from .diarize import diarize_turns

    y16 = resample(y, sr, 16000)
    return diarize_turns(
        np.asarray(y16, np.float32), encoder, num_speakers=num_speakers,
        min_turn_s=min_turn_s, win_s=win_s, hop_s=hop_s,
        speech_frac=speech_frac)


class DiarizationTool(BaseTool):
    """'diarization': per-speaker slices ≥1 s + optional Audacity labels
    (reference speaker_diarization/model.py:44-107)."""

    async def run(self, data: Dict, websocket=None):
        in_path = data.get("inPath") or data["inputDirectory"]
        out_dir = (data.get("outputDirectory")
                   or in_path.rstrip("/\\") + "_diarized")
        settings = data.get("toolSettings", {})
        make_labels = bool(settings.get("outputAudacityLabels", False))
        num_speakers = settings.get("numSpeakers")
        os.makedirs(out_dir, exist_ok=True)
        enc = _get_encoder(self.models_manager, self.device)
        files = list_audio_files(in_path)
        for fi, f in enumerate(files):
            y, sr = decode_any(f)
            turns = diarize(y, sr, enc,
                            int(num_speakers) if num_speakers else None)
            stem = os.path.splitext(os.path.basename(f))[0]
            for ti, t in enumerate(turns):
                sdir = os.path.join(out_dir, f"speaker_{t['speaker']}")
                os.makedirs(sdir, exist_ok=True)
                seg = y[int(t["start"] * sr) : int(t["end"] * sr)]
                save_wav(os.path.join(sdir, f"{stem}_{ti:04d}.wav"), seg, sr)
            if make_labels:
                with open(os.path.join(out_dir, stem + "_labels.txt"), "w") as lf:
                    for t in turns:
                        lf.write(f"{t['start']:.3f}\t{t['end']:.3f}\tspeaker_{t['speaker']}\n")
            self.write_progress(out_dir, fi + 1, len(files))
        await self.done(websocket)
