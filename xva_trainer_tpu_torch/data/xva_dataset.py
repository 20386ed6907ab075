"""The v3 (xVAPitch) data path: the feature cache, speaker embeddings, the
dataset centroid and the priors, loss-sorted resampling and the batcher.

Counterpart of ``xva_trainer_tpu/data/xva_dataset.py``, reading and writing
the same files, so that either package reads and extends the other's cache:
``<dataset>/.tpu_cache_v3/<item_id>.npz`` (``linear``, ``pitch``,
``energy``, ``tokens``, ``wav``, ``lang_id``) with its pack, pin and corrupt
list, ``se_embs/<name>.npy``, ``emb.txt`` and ``other_embs.txt``.

Where the port differs from the JAX module, on purpose:

- A fresh cache pins the ``"pallas"`` variant: the fused CUDA kernel, which
  on the H100 is faster than the ``torch.stft`` chain at the step's shape
  (``PERF.md`` §6). A cache pinned ``"fft"`` by the JAX package keeps its
  pin, but the port computes its items with the fused kernel too: the
  port has one spectrogram path.
- ``build`` has one path, the batched one. A failure in it raises; there is
  no serial fallback.
- The dataset centroid comes from the port's own k-means (numpy, k-means++,
  a seeded generator), not from scikit-learn.
"""
from __future__ import annotations

import functools
import logging
import os
import random
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import resolve_device
from ..ops.features import featurize_batch
from ..ops.stft import DEFAULT_MEL, MelConfig
from .audio_io import load_wav, resample
from .dataset import (DECODE_CHUNK, Bucket, Utterance, atomic_savez, drop_known_corrupt,
                      heal_corrupt_item, read_metadata, sticky_mel_variant)
from .packed import PackedReader, pack_cache

log = logging.getLogger("xva")

# f0 statistics of the xVASpeech data the base model was trained on; the
# feature cache stores (f0 - mean) / std on voiced frames and 0 elsewhere
XVASPEECH_PITCH_MEAN = 104.606
XVASPEECH_PITCH_STD = 123.4384

LANG_CODES = [
    "am", "ar", "da", "de", "el", "en", "es", "fi", "fr", "ha", "hi", "hu",
    "it", "jp", "ko", "la", "nl", "pl", "pt", "ro", "ru", "sw", "sv", "th",
    "tr", "uk", "vi", "wo", "yo", "zh", "mn",
]  # 31 languages (reference python/xvapitch/text/__init__.py:5-37)

CACHE_DIR = ".tpu_cache_v3"  # the JAX package's name, so both share a cache


def lang_to_id(lang: str) -> int:
    lang = (lang or "en").lower()
    return LANG_CODES.index(lang) if lang in LANG_CODES else LANG_CODES.index("en")


def normalize_pitch(f0: np.ndarray) -> np.ndarray:
    """Hz f0 (0 where unvoiced) → the cache's normalised pitch."""
    return np.where(f0 > 0, (f0 - XVASPEECH_PITCH_MEAN) / XVASPEECH_PITCH_STD,
                    0.0).astype(np.float32)


# ---------------- the feature cache ----------------


class XvaFeatureCache:
    """Per-utterance cache: tokens, linear spectrogram, pitch, energy, wav.

    ``use_pallas`` picks the variant a fresh cache pins in ``.mel_variant``
    (None: the port's default, ``"pallas"``); an existing pin is always
    followed, so the JAX package never mixes its variants in one cache. The
    port computes both variants with ``featurize_batch``: on the card the
    fused kernel, which differs from either JAX variant by fp32 rounding
    only. ``device`` is where ``build`` featurizes."""

    def __init__(
        self,
        dataset_path: str,
        text_to_ids: Callable[[str], np.ndarray],
        lang: str = "en",
        mel_cfg: MelConfig = DEFAULT_MEL,
        use_pallas: Optional[bool] = None,
        device="cuda",
    ):
        self.dataset_path = dataset_path
        self.lang = lang
        self.lang_id = lang_to_id(lang)
        self.cache_dir = os.path.join(dataset_path, CACHE_DIR)
        os.makedirs(self.cache_dir, exist_ok=True)
        self.mel_cfg = mel_cfg
        self.text_to_ids = text_to_ids
        self.items = read_metadata(dataset_path)
        drop_known_corrupt(self)
        self.use_pallas = True if use_pallas is None else use_pallas
        self.device = device
        # wall seconds of the last build by stage: decode (the thread pool and
        # healing), featurize, write (the npzs), pack
        self.build_seconds: Dict[str, float] = {}
        self._packed = PackedReader(self.cache_dir)

    def _cache_path(self, item: Utterance) -> str:
        return os.path.join(self.cache_dir, item.item_id + ".npz")

    def _decode_item(self, item: Utterance, heal: bool = True):
        """Wav samples of one item (the postprocessed wav preferred), cut to a
        hop multiple; None when it cannot be read, False when it is too short
        (skipped).

        ``heal=False`` leaves ``heal_corrupt_item`` to the caller, as the
        thread-pool workers must: healing reassigns ``self.items`` and appends
        to ``corrupt_wavs.txt``, neither of which is thread-safe.
        """
        post = os.path.join(self.dataset_path, "wavs_postprocessed",
                            os.path.basename(item.wav_path))
        src = post if os.path.exists(post) else item.wav_path
        try:
            y, _ = load_wav(src, target_sr=self.mel_cfg.sample_rate)
        except Exception:  # noqa: BLE001 — any unreadable file is healed, not fatal
            # a truncated postprocessed file must not cost the intact
            # original: try that before healing
            if src != item.wav_path:
                try:
                    y, _ = load_wav(item.wav_path, target_sr=self.mel_cfg.sample_rate)
                except Exception:  # noqa: BLE001
                    if heal:
                        heal_corrupt_item(self, item, bad_path=item.wav_path)
                    return None
            else:
                if heal:
                    heal_corrupt_item(self, item, bad_path=src)
                return None
        hop = self.mel_cfg.hop_length
        y = y[: len(y) // hop * hop]
        return y if len(y) >= hop * 40 else False  # skip clips under 40 frames

    def build(self, progress=None) -> None:
        """Featurize every item not yet cached, then pack the cache.

        Items are decoded by a thread pool, ``DECODE_CHUNK`` at a time; the
        unreadable ones are healed on this thread; each chunk is featurized by
        ``featurize_batch(mode="linear")`` on ``self.device`` (groups of at
        most 8 clips a spectrogram call) and written one npz an item. Any
        failure raises."""
        dev = resolve_device(self.device)
        todo = [it for it in self.items if not os.path.exists(self._cache_path(it))]
        variant = sticky_mel_variant(self.cache_dir, "pallas" if self.use_pallas else "fft")
        self.use_pallas = variant == "pallas"
        secs = {"decode": 0.0, "featurize": 0.0, "write": 0.0, "pack": 0.0}
        done = 0
        if todo:
            decode = functools.partial(self._decode_item, heal=False)
            with ThreadPoolExecutor(max_workers=max(2, os.cpu_count() or 2)) as ex:
                for c0 in range(0, len(todo), DECODE_CHUNK):
                    t0 = time.perf_counter()
                    chunk_items = todo[c0: c0 + DECODE_CHUNK]
                    decoded = list(ex.map(decode, chunk_items))
                    for it, y in zip(chunk_items, decoded):
                        if y is None:
                            heal_corrupt_item(self, it)
                    good = [(it, y) for it, y in zip(chunk_items, decoded)
                            if y is not None and y is not False]
                    t1 = time.perf_counter()
                    feats = featurize_batch([y for _, y in good], self.mel_cfg, mode="linear",
                                            device=dev)
                    t2 = time.perf_counter()
                    for (item, y), f in zip(good, feats):
                        atomic_savez(
                            self._cache_path(item),
                            linear=f["linear"], pitch=normalize_pitch(f["pitch"]),
                            energy=f["energy"],
                            tokens=np.asarray(self.text_to_ids(item.text), np.int32),
                            wav=y.astype(np.float32),
                            lang_id=np.int32(self.lang_id),
                        )
                        done += 1
                        if progress:
                            progress(done, len(todo))
                    # healed and too-short items count as processed too
                    done = c0 + len(chunk_items)
                    if progress:
                        progress(done, len(todo))
                    secs["decode"] += t1 - t0
                    secs["featurize"] += t2 - t1
                    secs["write"] += time.perf_counter() - t2
        t0 = time.perf_counter()
        self.pack()
        secs["pack"] = time.perf_counter() - t0
        self.build_seconds = secs

    def pack(self) -> None:
        """(Re)build the mmap pack from the per-item npzs (``data/packed.py``)."""
        pack_cache(self.cache_dir)
        self._packed = PackedReader(self.cache_dir)

    def load_item(self, item: Utterance) -> Optional[Dict[str, np.ndarray]]:
        if self._packed and item.item_id in self._packed:
            return self._packed.load(item.item_id)
        p = self._cache_path(item)
        if not os.path.exists(p):
            return None
        with np.load(p) as z:
            return {k: z[k] for k in z.files}


# ---------------- speaker embeddings and priors ----------------


def extract_speaker_embeddings(
    dataset_path: str,
    speaker_encoder=None,
    use_postprocessed: bool = False,
    progress=None,
) -> int:
    """Write each item's speaker embedding to ``se_embs/<name>.npy``
    (reference dataset.py read_datasets:649-668, get_embedding:346-359).
    Returns the number of items that have one. An item that fails is logged
    and skipped, as in the JAX package."""
    if speaker_encoder is None:
        from ..models.speaker_encoder import SpeakerEncoder

        speaker_encoder = SpeakerEncoder()
    wav_dir = os.path.join(dataset_path, "wavs_postprocessed" if use_postprocessed else "wavs")
    if not os.path.isdir(wav_dir):
        wav_dir = os.path.join(dataset_path, "wavs")
    emb_dir = os.path.join(dataset_path, "se_embs")
    os.makedirs(emb_dir, exist_ok=True)
    items = read_metadata(dataset_path)
    done = 0
    for i, it in enumerate(items):
        emb_path = item_embedding_path(dataset_path, it)
        if os.path.exists(emb_path):
            done += 1
            continue
        wav_path = os.path.join(wav_dir, os.path.basename(it.wav_path))
        if not os.path.exists(wav_path):
            wav_path = it.wav_path
        try:
            y, sr = load_wav(wav_path)
            emb = speaker_encoder.compute_embedding(resample(y, sr, 16000))
            np.save(emb_path, emb.astype(np.float32))
            done += 1
        except Exception:  # noqa: BLE001 — one bad clip must not stop the dataset
            log.exception("speaker embedding of %s skipped", wav_path)
            continue
        if progress:
            progress(i + 1, len(items))
    return done


def item_embedding_path(dataset_path: str, item: Utterance) -> str:
    name = os.path.splitext(os.path.basename(item.wav_path))[0]
    return os.path.join(dataset_path, "se_embs", name + ".npy")


def read_priors_datasets(
    languages: Sequence[str],
    dataset_roots: Sequence[str],
    speaker_encoder=None,
    data_mult: int = 1,
    extract_embs: bool = True,
    progress=None,
):
    """Walk priors roots for ``<lang>_<name>/metadata.csv`` datasets and
    extract their missing per-item speaker embeddings (reference dataset.py
    read_datasets:588-684). Returns (dataset_dirs, languages_loaded)."""
    langs = set(languages)
    all_datasets: List[str] = []
    languages_loaded = set()
    for root in dataset_roots:
        if os.path.exists(os.path.join(root, "metadata.csv")):
            all_datasets.append(root)
        for fname in sorted(os.listdir(root)):
            sub = os.path.join(root, fname)
            if ("." not in fname and "_" in fname and fname.split("_")[0] in langs
                    and os.path.exists(os.path.join(sub, "metadata.csv"))):
                all_datasets.append(sub)
                languages_loaded.add(fname.split("_")[0])
    if extract_embs:
        for di, d in enumerate(all_datasets):
            extract_speaker_embeddings(d, speaker_encoder)
            if progress:
                progress(di + 1, len(all_datasets))
    return all_datasets * max(1, data_mult), sorted(languages_loaded)


def language_weights(langs: Sequence[str]) -> np.ndarray:
    """Inverse-frequency sampling weights per item (reference util.py
    get_language_weighted_sampler:403-410)."""
    langs = list(langs)
    counts = {u: langs.count(u) for u in set(langs)}
    return np.asarray([1.0 / counts[lang] for lang in langs], np.float64)


def kmeans(x: np.ndarray, k: int, n_init: int = 4, seed: int = 0, max_iter: int = 300,
           tol: float = 1e-4) -> Tuple[np.ndarray, np.ndarray]:
    """Lloyd's k-means of the rows of ``x`` from ``n_init`` k-means++ starts
    drawn by ``np.random.default_rng(seed)``; the start whose result has the
    least inertia wins. A run stops when the centres move by at most ``tol``
    times the data's mean per-feature variance (scikit-learn's criterion) or
    after ``max_iter`` steps. Returns (centres (k, d), labels (n,))."""
    x = np.asarray(x, np.float64)
    rng = np.random.default_rng(seed)
    stop = tol * float(np.var(x, axis=0).mean())
    x2 = (x * x).sum(axis=1)

    def sq_dist(c):
        return np.maximum(x2[:, None] - 2.0 * x @ c.T + (c * c).sum(axis=1)[None], 0.0)

    best = None
    for _ in range(n_init):
        centres = [x[rng.integers(len(x))]]
        for _ in range(1, k):  # k-means++: the next centre drawn in proportion to D^2
            d2 = sq_dist(np.stack(centres)).min(axis=1)
            p = d2 / d2.sum() if d2.sum() > 0 else None
            centres.append(x[rng.choice(len(x), p=p)])
        c = np.stack(centres)
        for _ in range(max_iter):
            labels = sq_dist(c).argmin(axis=1)
            new = np.stack([x[labels == j].mean(axis=0) if (labels == j).any() else c[j]
                            for j in range(k)])
            shift = float(((new - c) ** 2).sum())
            c = new
            if shift <= stop:
                break
        d = sq_dist(c)
        labels = d.argmin(axis=1)
        inertia = float(d.min(axis=1).sum())
        if best is None or inertia < best[0]:
            best = (inertia, c, labels)
    return best[1], best[2]


def get_dataset_embedding(
    dataset_path: str,
    speaker_encoder=None,
    n_clusters: int = 10,
    max_files: int = 60,
) -> Dict[str, np.ndarray]:
    """The main voice's centroid (the largest cluster's) and the other style
    centroids of the first ``max_files`` items, cached to ``emb.txt`` and
    ``other_embs.txt`` (reference python/xvapitch/get_dataset_emb.py:7-66)."""
    emb_path = os.path.join(dataset_path, "emb.txt")
    other_path = os.path.join(dataset_path, "other_embs.txt")
    if os.path.exists(emb_path) and os.path.exists(other_path):
        main = np.loadtxt(emb_path, delimiter=",")
        others = np.loadtxt(other_path, delimiter=",")
        return {"main": main.astype(np.float32), "others": others.astype(np.float32)}

    if speaker_encoder is None:
        from ..models.speaker_encoder import SpeakerEncoder

        speaker_encoder = SpeakerEncoder()
    embs = []
    for it in read_metadata(dataset_path)[:max_files]:
        y, sr = load_wav(it.wav_path)
        embs.append(speaker_encoder.compute_embedding(resample(y, sr, 16000)))
    embs = np.stack(embs)
    k = min(n_clusters, len(embs))
    if k >= 2:
        centres, labels = kmeans(embs, k, n_init=4, seed=0)
        largest = np.bincount(labels, minlength=k).argmax()
        main = centres[largest]
        others = np.delete(centres, largest, axis=0)
    else:
        main = embs.mean(axis=0)
        others = embs[:1]
    np.savetxt(emb_path, main[None], delimiter=",")
    np.savetxt(other_path, others, delimiter=",")
    return {"main": main.astype(np.float32), "others": others.astype(np.float32)}


def get_similar_priors(
    target_emb: np.ndarray,
    priors_root: str,
    top_k: int = 12,
    speaker_encoder=None,
) -> List[str]:
    """Rank the priors datasets (``<lang>_<name>`` dirs) by the cosine
    similarity of their main centroid to the fine-tune voice's (reference
    get_dataset_emb.py get_similar_priors:71-151, faiss there)."""
    dirs = sorted(
        os.path.join(priors_root, d) for d in os.listdir(priors_root)
        if os.path.isdir(os.path.join(priors_root, d))
        and os.path.exists(os.path.join(priors_root, d, "metadata.csv")))
    embs = [get_dataset_embedding(d, speaker_encoder)["main"] for d in dirs]
    if not embs:
        return []
    E = np.stack(embs)
    E = E / np.maximum(np.linalg.norm(E, axis=1, keepdims=True), 1e-8)
    q = target_emb / max(np.linalg.norm(target_emb), 1e-8)
    order = np.argsort(-(E @ q))[:top_k]
    return [dirs[i] for i in order]


# ---------------- batching ----------------


def loss_sorted_resample(loss_by_item: Dict[str, float],
                         rng: Optional[random.Random] = None) -> List[str]:
    """Gaussian mid-band resampling of the loss-sorted items, doubled up
    (reference dataset.py calibrate_loss_sampling:164-220)."""
    rng = rng or random.Random(1234)
    ranked = sorted(loss_by_item.items(), key=lambda kv: kv[1])
    n = len(ranked)
    target = int(n * 0.5)
    picked: List[int] = []
    it = 0
    while len(picked) < target and it < 100000:
        it += 1
        v = rng.gauss(100, 50)
        if 0 <= v < 200:
            idx = int(v / 200 * n)
            if idx not in picked:
                picked.append(idx)
    picked = picked + picked  # double up (reference :211)
    return [ranked[i][0] for i in picked]


DEFAULT_V3_BUCKETS = (
    Bucket(64, 256),
    Bucket(96, 384),
    Bucket(128, 512),
    Bucket(192, 768),
)


class XvaBatcher:
    """Static-shape v3 batches over one or more ``XvaFeatureCache``s.

    Its numpy generator draws what the JAX batcher's draws, in the same
    order, so both give equal batches from one cache and seed. Batches are
    numpy; ``data/prefetch.py::batch_to_device`` moves one to the
    card."""

    # decoder and discriminator activations scale with the batch alone (they
    # see fixed-size segments), so the short buckets' batch grows at most 2x
    MAX_BUCKET_SCALE = 2.0

    def __init__(
        self,
        caches: Sequence[XvaFeatureCache],
        batch_size: int,
        d_vector: np.ndarray,
        buckets: Sequence[Bucket] = DEFAULT_V3_BUCKETS,
        seed: int = 0,
        hop: int = 256,
    ):
        self.caches = list(caches)
        self.batch_size = batch_size
        self.d_vector = np.asarray(d_vector, np.float32)
        self.buckets = sorted(buckets, key=lambda b: b.mel_len)
        self.rng = np.random.default_rng(seed)
        self.hop = hop
        self.use_item_embs = True   # per-item se_embs/*.npy when present
        self.weighted_by_language = False
        # device_spec: ship int16 audio and no linear spectrogram; the train
        # step computes it on the card (materialize_spec). Else the cached
        # float32 linear (B, mel_len, 513) and float32 audio are shipped.
        self.device_spec = False
        self._emb_cache: Dict[str, Optional[np.ndarray]] = {}
        self._index: List = []  # (cache, item)
        for c in self.caches:
            for it in c.items:
                if os.path.exists(c._cache_path(it)):
                    self._index.append((c, it))
        self._active = list(self._index)
        # (dataset_path, item_id) -> (text_len, spec_len): bare item ids
        # collide across the datasets of a priors batcher
        self._lengths: Dict[tuple, tuple] = {}
        # each bucket's batch stays a multiple of this
        self.batch_divisor = 1

    def __len__(self):
        """Batches in one (unshuffled) epoch plan."""
        plans = self._plan(list(self._active))
        n = sum(int(np.ceil(len(v) / self.batch_size_for(b))) for b, v in plans.items() if v)
        return max(1, n)

    def batch_size_for(self, b: Bucket) -> int:
        """A batch of about constant memory: ``batch_size`` at the largest
        bucket, scaled up inversely with the bucket's frames (at most
        ``MAX_BUCKET_SCALE`` times) and rounded down to ``batch_divisor``."""
        max_len = self.buckets[-1].mel_len
        scale = min(max_len / b.mel_len, self.MAX_BUCKET_SCALE)
        n = int(round(self.batch_size * scale))
        d = max(1, self.batch_divisor)
        return max(d, (max(1, n) // d) * d)

    @staticmethod
    def item_key(cache, item) -> str:
        """Collision-safe item name across datasets: '<dataset_path>::<item_id>'."""
        return f"{cache.dataset_path}::{item.item_id}"

    def resample_by_loss(self, loss_by_item: Dict[str, float]):
        names = loss_sorted_resample(loss_by_item)
        by_name = {self.item_key(c, it): (c, it) for c, it in self._index}
        self._active = [by_name[n] for n in names if n in by_name]
        if not self._active:
            self._active = list(self._index)

    def _item_emb(self, cache: XvaFeatureCache, item: Utterance):
        if not self.use_item_embs:
            return None
        p = item_embedding_path(cache.dataset_path, item)
        if p in self._emb_cache:
            return self._emb_cache[p]
        emb = np.load(p).astype(np.float32).reshape(-1) if os.path.exists(p) else None
        self._emb_cache[p] = emb
        return emb

    def _plan(self, order) -> Dict[Bucket, List]:
        """Items by bucket (the first that holds both lengths); the lengths
        are memoised, so each item is read once across epochs."""
        plans: Dict[Bucket, List] = {b: [] for b in self.buckets}
        for c, it in order:
            key = (c.dataset_path, it.item_id)
            lens = self._lengths.get(key)
            if lens is None:
                d = c.load_item(it)
                if d is None:
                    continue
                lens = (len(d["tokens"]), d["linear"].shape[1])
                self._lengths[key] = lens
            tl, sl = lens
            for b in self.buckets:
                if tl <= b.text_len and sl <= b.mel_len:
                    plans[b].append((c, it))
                    break
        return plans

    def mean_batch_size(self) -> float:
        """Items per batch over one epoch plan: the divisor of the gradient
        accumulation, gam = ceil(target_bs / mean)."""
        plans = self._plan(list(self._active))
        items = sum(len(v) for v in plans.values())
        batches = sum(int(np.ceil(len(v) / self.batch_size_for(b)))
                      for b, v in plans.items() if v)
        return items / batches if batches else float(self.batch_size)

    def epoch(self, shuffle: bool = True):
        order = list(self._active)
        if shuffle and self.weighted_by_language:
            # inverse language-frequency sampling with replacement
            # (reference util.py:403-410, WeightedRandomSampler)
            w = language_weights([c.lang for c, _ in order])
            idx = self.rng.choice(len(order), size=len(order), replace=True, p=w / w.sum())
            order = [order[i] for i in idx]
        elif shuffle:
            self.rng.shuffle(order)
        batches = []
        for b, items in self._plan(order).items():
            bs = self.batch_size_for(b)
            for s in range(0, len(items), bs):
                batches.append((b, items[s: s + bs]))
        if shuffle:
            self.rng.shuffle(batches)
        for b, chunk in batches:
            yield self.collate(b, chunk)

    def collate(self, b: Bucket, chunk) -> Dict[str, np.ndarray]:
        n = self.batch_size_for(b)
        # a partial tail chunk repeats its real items to fill the static
        # batch: all-zero rows would put silence into the mel, adversarial
        # and discriminator losses every epoch
        ids = [self.item_key(c, it) for c, it in chunk]
        if 0 < len(chunk) < n:
            chunk = [chunk[i % len(chunk)] for i in range(n)]
        loaded: Dict[str, Dict[str, np.ndarray]] = {}  # one read per unique item
        tokens = np.zeros((n, b.text_len), np.int32)
        tlens = np.ones((n,), np.int32)
        linear = None if self.device_spec else np.zeros((n, b.mel_len, 513), np.float32)
        slens = np.ones((n,), np.int32)
        pitch = np.zeros((n, 1, b.mel_len), np.float32)
        energy = np.zeros((n, b.mel_len), np.float32)
        wav = np.zeros((n, b.mel_len * self.hop, 1), np.int16 if self.device_spec else np.float32)
        lang = np.zeros((n,), np.int32)
        dvec = np.tile(self.d_vector[None], (n, 1))
        for i, (c, it) in enumerate(chunk):
            k = self.item_key(c, it)
            d = loaded.get(k)
            if d is None:
                d = loaded[k] = c.load_item(it)
            tl = min(len(d["tokens"]), b.text_len)
            sl = min(d["linear"].shape[1], b.mel_len)
            tokens[i, :tl] = d["tokens"][:tl]
            tlens[i] = max(tl, 1)
            if linear is not None:
                linear[i, :sl] = d["linear"][:, :sl].T
            slens[i] = max(sl, 1)
            pitch[i, 0, :sl] = d["pitch"][:sl]
            energy[i, :sl] = d["energy"][:sl]
            w = d["wav"][: sl * self.hop]
            if self.device_spec:
                # symmetric int16, dequantised on the card as wav / 32767
                w = np.round(np.clip(w, -1.0, 1.0) * 32767.0).astype(np.int16)
            wav[i, : len(w), 0] = w
            lang[i] = int(np.asarray(d["lang_id"]).reshape(-1)[0])
            emb = self._item_emb(c, it)
            if emb is not None and emb.shape == dvec[i].shape:
                dvec[i] = emb
        out = {"tokens": tokens, "tlens": tlens, "slens": slens, "pitch": pitch,
               "energy": energy, "wav": wav, "dvec": dvec, "lang": lang, "ids": ids}
        if linear is not None:
            out["linear"] = linear
        return out
