"""Port parity of the speaker encoder and what stands on it: the mel front
end (within 1e-4 relative), the embedding with JAX parameters carried across
(within 1e-3 L1), the 10-crop ``compute_embedding``, the key set of a strict
load, ``extract_speaker_embeddings`` (files within 1e-3 L1), the k-means of
``get_dataset_embedding`` against scikit-learn's on separable clusters, and
``get_similar_priors``'s ranking.

The repository holds no ``speaker_rep.pt``, so the encoder's parameters are
seeded (batch statistics included) and carried from the JAX tree to the
port by the port's copy of the rules.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xva_trainer_tpu import native
from xva_trainer_tpu.data import xva_dataset as jxd
from xva_trainer_tpu.models.speaker_encoder import ResNetSpeakerEncoder as JaxEncoder
from xva_trainer_tpu.models.speaker_encoder import SpeakerEncoder as JaxSpeakerEncoder
from xva_trainer_tpu.models.speaker_encoder import spk_mel_spectrogram as jax_spk_mel
from xva_trainer_tpu_torch.data import xva_dataset as pxd
from xva_trainer_tpu_torch.data.audio_io import save_wav
from xva_trainer_tpu_torch.interop.convert import speaker_encoder_state_dict
from xva_trainer_tpu_torch.interop.speaker_map import batch_norm_prefixes, speaker_encoder_rules
from xva_trainer_tpu_torch.models.speaker_encoder import (ResNetSpeakerEncoder, SpeakerEncoder,
                                                          spk_mel_spectrogram)
from xva_trainer_tpu_torch.models.speaker_encoder.model import load_speaker_rep


@pytest.fixture(autouse=True)
def scipy_only(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    torch.set_num_threads(2)


def _voice(f0, seconds, seed, sr=16000):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    y = sum((0.5 / k) * np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6)) for k in range(1, 6))
    return (0.3 * y + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def variables():
    """Seeded JAX encoder variables: kernels N(0, 1/fan_in), BatchNorm
    scales 1 + N(0, 0.1), running variances in [1, 1.5), the rest
    N(0, 0.1)."""
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(JaxEncoder().init, jax.random.PRNGKey(0), jnp.zeros((1, 16000)))

    def leaf(path, s):
        name = getattr(path[-1], "key", "")
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(
                np.float32)
        if name == "var":
            return (1.0 + 0.5 * rng.random(s.shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map_with_path(leaf, shapes))


@pytest.fixture(scope="module")
def encoders(variables):
    return (SpeakerEncoder(state_dict=speaker_encoder_state_dict(variables), device="cpu"),
            JaxSpeakerEncoder(params=variables))


@pytest.mark.parametrize("n", [16000, 12345, 40000])
def test_spk_mel_spectrogram_matches_jax(n):
    y = np.stack([_voice(120, n / 16000, 0), _voice(230, n / 16000, 1)])
    ours = spk_mel_spectrogram(torch.from_numpy(y)).numpy()
    ref = np.asarray(jax_spk_mel(jnp.asarray(y)))
    assert ours.shape == ref.shape == (2, 64, 1 + n // 160)
    assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()


def test_rule_keys_are_the_modules_state_dict(variables):
    """The state dict the rules build loads the port's module strictly: its
    keys are exactly the module's."""
    sd = speaker_encoder_state_dict(variables)
    module_keys = set(ResNetSpeakerEncoder().state_dict())
    assert set(sd) == module_keys
    rule_keys = {r.torch_key for r in speaker_encoder_rules()}
    assert rule_keys | {p + ".num_batches_tracked" for p in batch_norm_prefixes()} == module_keys
    assert {"conv1.weight", "layer1.0.se.fc.0.weight", "layer2.0.downsample.1.running_var",
            "attention.3.bias", "fc.weight"} <= rule_keys
    assert not any(k.startswith("layer1.0.downsample") for k in rule_keys)


def test_speaker_rep_file_loads_strictly(variables, tmp_path):
    """A reference-layout ``speaker_rep.pt`` ({"model": state dict}, with the
    reference's front-end buffers) loads with ``strict=True``."""
    sd = speaker_encoder_state_dict(variables)
    ref_file = dict(sd, **{"torch_spec.0.filter": torch.tensor([[[-0.97, 1.0]]]),
                           "torch_spec.1.spectrogram.window": torch.hamming_window(400)})
    path = str(tmp_path / "speaker_rep.pt")
    torch.save({"model": ref_file}, path)
    enc = SpeakerEncoder(weights_path=path, device="cpu")
    assert enc.pretrained
    for k, v in enc.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    bad = dict(sd)
    bad.pop("fc.bias")
    torch.save(bad, path)
    with pytest.raises(RuntimeError, match="fc.bias"):
        SpeakerEncoder(weights_path=path, device="cpu")
    assert set(load_speaker_rep(path)) == set(bad)


def test_embedding_matches_jax(variables):
    y = np.stack([_voice(110, 2.0, 1), _voice(300, 2.0, 2)])
    m = ResNetSpeakerEncoder()
    m.load_state_dict(speaker_encoder_state_dict(variables), strict=True)
    with torch.no_grad():
        ours = m(torch.from_numpy(y), l2_norm=True).numpy()
        raw = m(torch.from_numpy(y)).numpy()
    ref = np.asarray(JaxEncoder().apply(variables, jnp.asarray(y), l2_norm=True))
    ref_raw = np.asarray(JaxEncoder().apply(variables, jnp.asarray(y)))
    assert np.abs(ours - ref).sum(axis=1).max() < 1e-3
    assert np.abs(raw - ref_raw).sum(axis=1).max() < 1e-3 * np.abs(ref_raw).sum(axis=1).max()


@pytest.mark.parametrize("seconds", [1.0, 3.3])  # under and over one 250-frame crop
def test_compute_embedding_matches_jax(encoders, seconds):
    ours, ref = encoders
    y = _voice(170, seconds, 3)
    a, b = ours.compute_embedding(y), ref.compute_embedding(y)
    assert a.shape == b.shape == (512,) and a.dtype == np.float32
    assert np.abs(a - b).sum() < 1e-3
    assert abs(np.linalg.norm(a) - 1.0) < 1e-5


def _dataset(path, seconds=(0.7, 1.3, 2.1), seed=0):
    os.makedirs(os.path.join(path, "wavs"))
    rng = np.random.default_rng(seed)
    lines = []
    for i, s in enumerate(seconds):
        save_wav(os.path.join(path, "wavs", f"s{i}.wav"),
                 _voice(rng.uniform(100, 250), s, seed * 10 + i, sr=22050))
        lines.append(f"s{i}.wav|line {i}")
    lines.append("gone.wav|no such file")
    with open(os.path.join(path, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return path


def test_extract_speaker_embeddings_matches_jax(encoders, tmp_path):
    ours_enc, ref_enc = encoders
    ds = _dataset(str(tmp_path / "port"))
    shutil.copytree(ds, str(tmp_path / "jax"))
    # one postprocessed wav: used with use_postprocessed, the others fall back
    os.makedirs(os.path.join(ds, "wavs_postprocessed"))
    shutil.copy(os.path.join(ds, "wavs", "s1.wav"), os.path.join(ds, "wavs_postprocessed"))
    shutil.copytree(os.path.join(ds, "wavs_postprocessed"),
                    str(tmp_path / "jax" / "wavs_postprocessed"))
    with open(os.path.join(ds, "wavs", "s2.wav"), "wb") as f:  # unreadable: skipped
        f.write(b"RIFF\x00\x00broken")
    shutil.copy(os.path.join(ds, "wavs", "s2.wav"), str(tmp_path / "jax" / "wavs"))
    n_ours = pxd.extract_speaker_embeddings(ds, ours_enc, use_postprocessed=True)
    n_ref = jxd.extract_speaker_embeddings(str(tmp_path / "jax"), ref_enc, use_postprocessed=True)
    assert n_ours == n_ref == 2
    files = sorted(os.listdir(os.path.join(ds, "se_embs")))
    assert files == sorted(os.listdir(str(tmp_path / "jax" / "se_embs"))) == ["s0.npy", "s1.npy"]
    for f in files:
        a = np.load(os.path.join(ds, "se_embs", f))
        b = np.load(str(tmp_path / "jax" / "se_embs" / f))
        assert a.dtype == b.dtype == np.float32 and np.abs(a - b).sum() < 1e-3, f
    # existing files are kept and counted
    assert pxd.extract_speaker_embeddings(ds, ours_enc) == 2


class _TableEncoder:
    """A stand-in encoder: the embedding of a clip is a row of ``table``,
    picked by the clip's length (one length per row)."""

    def __init__(self, table, base):
        self.table, self.base = table, base

    def compute_embedding(self, wav16k):
        return self.table[(len(wav16k) - self.base) // 160].copy()


def _cluster_fixture(path, n_per=(9, 4, 4, 3, 3, 3, 2, 2, 2, 2), dim=32, seed=0):
    """A dataset whose clips map to embeddings in 10 separable clusters, the
    first the largest."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((len(n_per), dim)) * 5.0
    table = np.concatenate([c + 0.05 * rng.standard_normal((n, dim))
                            for c, n in zip(centres, n_per)]).astype(np.float32)
    order = rng.permutation(len(table))
    table = table[order]
    os.makedirs(os.path.join(path, "wavs"))
    lines = []
    for i in range(len(table)):  # clip i has 16000 + 160 i samples at 16 kHz
        save_wav(os.path.join(path, "wavs", f"c{i:02d}.wav"),
                 np.full(16000 + 160 * i, 0.01, np.float32), sr=16000)
        lines.append(f"c{i:02d}.wav|clip {i}")
    with open(os.path.join(path, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return path, _TableEncoder(table, 16000)


def test_dataset_embedding_matches_sklearn(tmp_path):
    pytest.importorskip("sklearn")
    ours_ds, enc = _cluster_fixture(str(tmp_path / "port"))
    ref_ds = str(tmp_path / "jax")
    shutil.copytree(ours_ds, ref_ds)
    ours = pxd.get_dataset_embedding(ours_ds, enc)
    ref = jxd.get_dataset_embedding(ref_ds, enc)
    assert ours["main"].shape == ref["main"].shape == (32,)
    assert np.abs(ours["main"] - ref["main"]).max() < 1e-3
    assert ours["others"].shape == ref["others"].shape == (9, 32)
    for row in ref["others"]:  # the other centroids match as a set
        assert np.abs(ours["others"] - row).max(axis=1).min() < 1e-3
    # the cached files are read back alike by both packages
    for d in (ours_ds, ref_ds):
        again_ours, again_ref = pxd.get_dataset_embedding(d), jxd.get_dataset_embedding(d)
        np.testing.assert_array_equal(again_ours["main"], again_ref["main"])
        np.testing.assert_array_equal(again_ours["others"], again_ref["others"])


def test_kmeans_matches_sklearn():
    from sklearn.cluster import KMeans

    rng = np.random.default_rng(3)
    x = np.concatenate([c + 0.1 * rng.standard_normal((n, 8))
                        for c, n in zip(rng.standard_normal((5, 8)) * 4, (30, 12, 9, 7, 5))])
    centres, labels = pxd.kmeans(x.astype(np.float32), 5, n_init=4, seed=0)
    km = KMeans(n_clusters=5, n_init=4, random_state=0).fit(x.astype(np.float32))
    for c in km.cluster_centers_:
        assert np.abs(centres - c).max(axis=1).min() < 1e-4
    assert sorted(np.bincount(labels)) == sorted(np.bincount(km.labels_))


def test_similar_priors_rank_as_jax(tmp_path):
    rng = np.random.default_rng(4)
    root = tmp_path / "priors"
    for i, name in enumerate(["en_a", "de_b", "fr_c", "en_d", "es_e"]):
        d = root / name
        d.mkdir(parents=True)
        (d / "metadata.csv").write_text("x.wav|x\n")
        np.savetxt(d / "emb.txt", rng.standard_normal((1, 512)), delimiter=",")
        np.savetxt(d / "other_embs.txt", rng.standard_normal((3, 512)), delimiter=",")
    (root / "not_a_dataset").mkdir()
    target = rng.standard_normal(512).astype(np.float32)
    for top_k in (2, 12):
        ours = pxd.get_similar_priors(target, str(root), top_k=top_k)
        assert ours == jxd.get_similar_priors(target, str(root), top_k=top_k)
        assert len(ours) == min(top_k, 5)


def test_read_priors_datasets_matches_jax(encoders, tmp_path):
    ours_enc, _ = encoders
    root = tmp_path / "priors"
    for name in ("en_a", "de_b", "xx_c", "en.d"):
        _dataset(str(root / name), seconds=(0.6,))
    ours = pxd.read_priors_datasets(["en", "de"], [str(root)], ours_enc, data_mult=2)
    ref = jxd.read_priors_datasets(["en", "de"], [str(root)], ours_enc, data_mult=2)
    assert ours == ref
    assert ours[1] == ["de", "en"] and len(ours[0]) == 4
    assert os.path.exists(root / "en_a" / "se_embs" / "s0.npy")
    w = np.asarray(["en", "en", "de", "fr", "en"])
    np.testing.assert_array_equal(pxd.language_weights(w), jxd.language_weights(w))
