"""The port's speaker tools (``xva_trainer_tpu_torch/tools/speaker_tools.py``)
held to the JAX package's with one encoder under both: the JAX encoder's
seeded parameters carried across by ``interop/convert.py::
speaker_encoder_state_dict``. JAX's tools take it from the manager's
``shared_cache``, the port's from ``sync_init_model("speaker_encoder")``.

Three seeded "voices" (a harmonic at 110, 220 or 440 Hz gated at 1.5, 4 or
9 Hz), three clips each: with the encoder's biases at zero, their
embeddings fall into three separable groups. ``embed_files`` within 1e-3
L1; ``topk_similarity``'s order equal; ``cluster_speakers``' folders equal
(k-means: the same partition, as the port's k-means draws its own starts;
affinity propagation: the same folders, numbering included);
``speaker_search``'s copy order equal; the cluster-search report equal.
"""
import asyncio
import json
import os
import shutil

import numpy as np
import pytest
import torch

from torch_tools_common import seeded_variables
from xva_trainer_tpu import native
from xva_trainer_tpu.models.speaker_encoder import SpeakerEncoder as JaxSpeakerEncoder
from xva_trainer_tpu.tools import speaker_tools as jst
from xva_trainer_tpu_torch.app.manager import ModelsManager
from xva_trainer_tpu_torch.data.audio_io import save_wav
from xva_trainer_tpu_torch.interop.convert import speaker_encoder_state_dict
from xva_trainer_tpu_torch.models.speaker_encoder import SpeakerEncoder
from xva_trainer_tpu_torch.tools import speaker_tools as pst


@pytest.fixture(autouse=True)
def scipy_only(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    torch.set_num_threads(2)


class JaxManager:
    """What JAX's ``_get_encoder`` reads of its manager."""

    def __init__(self, enc):
        self.shared_cache = {"speaker_encoder": enc}


@pytest.fixture(scope="module")
def tools():
    """{side: (tool kwargs, encoder)}: the same weights in both packages."""
    v = seeded_variables()
    jenc = JaxSpeakerEncoder(params=v)
    penc = SpeakerEncoder(state_dict=speaker_encoder_state_dict(v), device="cpu")
    mgr = ModelsManager(device="cpu")
    mgr.models_bank["speaker_encoder"] = penc
    assert jenc.pretrained and penc.pretrained
    return {"jax": (dict(models_manager=JaxManager(jenc)), jenc),
            "torch": (dict(device="cpu", models_manager=mgr), penc)}


def voice(kind, seed, sr=22050, seconds=2.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    f0 = (110, 220, 440)[kind] * (1 + 0.02 * rng.standard_normal())
    y = sum((0.7 ** k) * np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6)) for k in range(1, 6))
    y *= np.sin(2 * np.pi * (1.5, 4.0, 9.0)[kind] * t + rng.uniform(0, 6)) > 0
    return (0.3 * y / np.abs(y).max() + 0.003 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def voices(tmp_path_factory):
    root = tmp_path_factory.mktemp("voices")
    for k in range(3):
        for i in range(3):
            save_wav(str(root / f"v{k}_{i}.wav"), voice(k, 10 * k + i))
    return root


@pytest.fixture(scope="module")
def embeddings(tools, voices):
    files = pst.list_audio_files(str(voices))
    return {side: pst.embed_files(files, enc) if side == "torch" else jst.embed_files(files, enc)
            for side, (_, enc) in tools.items()}


def run_tool(side, tools, key, data):
    cls = {("jax", "cluster"): jst.ClusterSpeakersTool, ("torch", "cluster"): pst.ClusterSpeakersTool,
           ("jax", "search"): jst.SpeakerSearchTool, ("torch", "search"): pst.SpeakerSearchTool,
           ("jax", "cluster_search"): jst.SpeakerClusterSearchTool,
           ("torch", "cluster_search"): pst.SpeakerClusterSearchTool}[(side, key)]
    sent = []

    class WS:
        async def send(self, msg):
            sent.append(json.loads(msg))

    asyncio.run(cls(**tools[side][0]).runTask(data, WS()))
    return sent


def test_embed_files_matches_jax(embeddings):
    j, p = embeddings["jax"], embeddings["torch"]
    assert p.shape == j.shape == (9, 512) and p.dtype == np.float32
    assert np.abs(p - j).mean(axis=1).max() < 1e-3
    # the voices are separable: each clip nearest its own voice
    d = ((p[:, None] - p[None]) ** 2).sum(-1)
    voice_of = np.repeat(np.arange(3), 3)
    for i in range(9):
        same = [d[i, k] for k in range(9) if k != i and voice_of[k] == voice_of[i]]
        other = [d[i, k] for k in range(9) if voice_of[k] != voice_of[i]]
        assert max(same) < min(other)


def test_topk_similarity_matches_jax(embeddings):
    """On the same embeddings the order is JAX's, ties included (two
    queries from the corpus tie with each other by symmetry); on each
    package's own embeddings, for single queries."""
    j, p = embeddings["jax"], embeddings["torch"]
    for q in ([0], [4], [6, 7], [1, 5, 8]):
        jo, js = jst.topk_similarity(j[q], j, k=9)
        po, ps = pst.topk_similarity(j[q], j, k=9)
        np.testing.assert_array_equal(po, jo)
        assert np.abs(ps - js).max() < 1e-6
    for q in range(9):
        np.testing.assert_array_equal(pst.topk_similarity(p[[q]], p, k=9)[0],
                                      jst.topk_similarity(j[[q]], j, k=9)[0])
    assert len(pst.topk_similarity(p[[0]], p)[0]) == 9  # k = 10 caps at the corpus


def partition(root):
    return sorted(sorted(os.listdir(os.path.join(root, d))) for d in os.listdir(root))


@pytest.mark.parametrize("k", [3, 0], ids=["kmeans", "affinity_propagation"])
def test_cluster_speakers_matches_jax(k, tools, voices, tmp_path):
    out = {}
    for side in tools:
        out[side] = str(tmp_path / side)
        sent = run_tool(side, tools, "cluster", {"inPath": str(voices), "outputDirectory": out[side],
                                                 "toolSettings": {"numClusters": k}})
        assert [e["key"] for e in sent] == ["task_info", "tasks_next"]
    groups = [[f"v{v}_{i}.wav" for i in range(3)] for v in range(3)]
    assert partition(out["torch"]) == partition(out["jax"]) == groups
    if k == 0:  # affinity propagation numbers clusters as scikit-learn does
        assert sorted(os.listdir(out["torch"])) == sorted(os.listdir(out["jax"]))
        for d in os.listdir(out["jax"]):
            assert sorted(os.listdir(os.path.join(out["torch"], d))) == sorted(
                os.listdir(os.path.join(out["jax"], d)))


def test_speaker_search_matches_jax(tools, voices, tmp_path):
    query = tmp_path / "query"
    query.mkdir()
    shutil.copy(voices / "v1_2.wav", query / "q.wav")
    out = {}
    for side in tools:
        sent = run_tool(side, tools, "search", {"queryPath": str(query), "corpusPath": str(voices),
                                                "outputDirectory": str(tmp_path / side)})
        assert [e["key"] for e in sent] == ["tasks_next"]
        out[side] = sorted(n for n in os.listdir(tmp_path / side) if n.endswith(".wav"))
    assert out["torch"] == out["jax"] and len(out["torch"]) == 9
    assert out["torch"][0] == "00000_v1_2.wav"
    assert {n[6:8] for n in out["torch"][:3]} == {"v1"}


def test_speaker_cluster_search_matches_jax(tools, voices, tmp_path):
    query = tmp_path / "query"
    query.mkdir()
    shutil.copy(voices / "v2_0.wav", query / "q.wav")
    reports = {}
    for side in tools:
        clusters = tmp_path / side
        for v in range(3):
            (clusters / f"cluster_{v}").mkdir(parents=True)
            for i in range(3):
                shutil.copy(voices / f"v{v}_{i}.wav", clusters / f"cluster_{v}")
        (clusters / "empty").mkdir()
        sent = run_tool(side, tools, "cluster_search", {"queryPath": str(query),
                                                        "corpusPath": str(clusters)})
        assert [e["key"] for e in sent] == ["task_info", "tasks_next"]
        reports[side] = (clusters / "cluster_search_results.txt").read_text()
        assert sent[0]["data"] == reports[side]
    assert reports["torch"] == reports["jax"]
    assert reports["torch"].splitlines()[0].startswith("cluster_2: ")
