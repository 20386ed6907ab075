"""Dataset metadata, the corrupt-item list, atomic npz writes, the
spectrogram-variant pin, and the v2 (FastPitch) feature cache and bucket
batcher.

The port's copy of ``xva_trainer_tpu/data/dataset.py``. ``metadata.csv``
holds ``<wav filename>|<transcript>[|...]`` one per line, with the wavs
under ``wavs/`` (reference python/xvapitch/dataset.py read_datasets).

The v2 ``FeatureCache`` reads and writes the JAX package's files:
``<dataset>/.tpu_cache/<item_id>.npz`` (``mel``, ``pitch`` in Hz,
``energy``, ``tokens``, ``wav_len``) with its pack, ``.mel_variant`` pin,
corrupt list, ``durs/<item_id>.npy`` and ``pitch_stats.json``, so that
either package reads and extends the other's cache. Where it differs from
the JAX class, on purpose:

- A fresh cache pins ``"pallas"``: the fused CUDA kernel, which the port
  runs for either variant (an existing ``"fft"`` pin is kept for the JAX
  package; the two differ by fp32 rounding, ``PERF.md`` §6).
- ``build`` has one path, the batched one, through
  ``ops/features.py::featurize_batch(mode="mel")``. A failure in it raises;
  the JAX class falls back to a serial build that computes the spectrogram
  another way.
- ``device`` says where the build featurizes.

``BucketBatcher`` gives the JAX batcher's batches on the same seed: the same
``np.random.default_rng(seed)`` draws in the same order, the same fp16 feed,
prior, durations and uniform-duration substitute.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

MEL_VARIANTS = ("fft", "pallas")


@dataclasses.dataclass
class Utterance:
    wav_path: str
    text: str
    item_id: str
    mel_len: int = 0
    text_len: int = 0


def read_metadata(dataset_path: str) -> List[Utterance]:
    """Parse <dataset>/metadata.csv with wavs under <dataset>/wavs/; lines
    whose wav does not exist are left out."""
    meta = os.path.join(dataset_path, "metadata.csv")
    items: List[Utterance] = []
    with open(meta, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split("|")
            stem = os.path.splitext(parts[0])[0]
            wav = os.path.join(dataset_path, "wavs", stem + ".wav")
            if os.path.exists(wav):
                items.append(Utterance(wav, parts[1] if len(parts) > 1 else "", stem))
    return items


def corrupt_wavs_path(cache_dir: str) -> str:
    return os.path.join(cache_dir, "corrupt_wavs.txt")


def load_corrupt_list(cache_dir: str) -> set:
    p = corrupt_wavs_path(cache_dir)
    if not os.path.exists(p):
        return set()
    with open(p, encoding="utf8") as f:
        return {line.strip() for line in f if line.strip()}


def heal_corrupt_item(cache, item: Utterance, bad_path: str = None) -> None:
    """Remove an unreadable item from a feature cache's items and record its
    wav in ``corrupt_wavs.txt``. The file is kept (the reference deletes it,
    python/xvapitch/dataset.py:335-338); the exclusion persists because the
    cache drops recorded paths when it is constructed. Works on any cache
    with ``items`` and ``cache_dir``."""
    cache.items = [it for it in cache.items if it.item_id != item.item_id]
    bad = bad_path or item.wav_path
    try:
        if bad not in load_corrupt_list(cache.cache_dir):
            with open(corrupt_wavs_path(cache.cache_dir), "a", encoding="utf8") as f:
                f.write(bad + "\n")
    except OSError:
        pass  # the item is dropped for this run either way


def drop_known_corrupt(cache) -> None:
    """Exclude the wavs healed by earlier runs (at cache construction)."""
    bad = load_corrupt_list(cache.cache_dir)
    if bad:
        cache.items = [it for it in cache.items if it.wav_path not in bad]


def atomic_savez(path: str, **arrays) -> None:
    """np.savez through a temporary file and ``os.replace``: a crash mid-write
    never leaves a truncated .npz behind, which a build (it checks only that
    the file exists) would skip forever."""
    tmp = path + ".tmp"  # not *.npz: pack_cache must never index leftovers
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def sticky_mel_variant(cache_dir: str, prefer: str) -> str:
    """One spectrogram variant per cache, persisted in ``.mel_variant``.

    The JAX package's two variants ("pallas": the fused kernel; "fft": the
    plain STFT magnitude) differ by about 1e-4, so a cache extended by the
    other one would mix them. The first build pins its variant; later
    builds, by either package, follow the pin. The port computes both with
    the fused kernel and keeps the pin for the JAX package."""
    p = os.path.join(cache_dir, ".mel_variant")
    try:
        if os.path.exists(p):
            with open(p, encoding="utf8") as f:
                v = f.read().strip()
            if v in MEL_VARIANTS:
                return v
        with open(p, "w", encoding="utf8") as f:
            f.write(prefer)
    except OSError:
        pass  # an unwritable cache dir: this build uses ``prefer`` unpinned
    return prefer


@dataclasses.dataclass(frozen=True)
class Bucket:
    text_len: int
    mel_len: int


# ---------------- the v2 (FastPitch) feature cache ----------------

CACHE_DIR_V2 = ".tpu_cache"  # the JAX package's name, so both share a cache
DECODE_CHUNK = 256           # items decoded at a time by the build's thread pool


class FeatureCache:
    """Precompute-once mel/pitch/energy cache under ``<dataset>/.tpu_cache/``.

    ``use_pallas`` picks the variant a fresh cache pins (None: ``"pallas"``);
    an existing pin is followed. ``device`` is where ``build`` featurizes."""

    def __init__(self, dataset_path: str, text_to_ids: Callable[[str], np.ndarray],
                 mel_cfg=None, use_pallas: Optional[bool] = None, device="cuda"):
        from ..ops.stft import DEFAULT_MEL
        from .packed import PackedReader

        self.dataset_path = dataset_path
        self.cache_dir = os.path.join(dataset_path, CACHE_DIR_V2)
        os.makedirs(self.cache_dir, exist_ok=True)
        self.mel_cfg = mel_cfg or DEFAULT_MEL
        self.text_to_ids = text_to_ids
        self.items = read_metadata(dataset_path)
        drop_known_corrupt(self)
        self.use_pallas = True if use_pallas is None else use_pallas
        self.device = device
        # wall seconds of the last build by stage: decode, featurize, write, pack
        self.build_seconds: Dict[str, float] = {}
        self._packed = PackedReader(self.cache_dir)

    def _cache_path(self, item: Utterance) -> str:
        return os.path.join(self.cache_dir, item.item_id + ".npz")

    @property
    def durs_dir(self) -> str:
        """Pre-extracted durations (reference durs_arpabet/durs_text dirs,
        fastpitch1_1/xva_train.py:1120-1168)."""
        d = os.path.join(self.cache_dir, "durs")
        os.makedirs(d, exist_ok=True)
        return d

    def save_durations(self, item_id: str, durs: np.ndarray) -> None:
        np.save(os.path.join(self.durs_dir, item_id + ".npy"), durs)

    def load_durations(self, item_id: str) -> Optional[np.ndarray]:
        p = os.path.join(self.durs_dir, item_id + ".npy")
        return np.load(p) if os.path.exists(p) else None

    def has_durations(self) -> bool:
        d = os.path.join(self.cache_dir, "durs")
        return os.path.isdir(d) and len(os.listdir(d)) >= len(self.items)

    def max_file_len_sec(self) -> float:
        """Longest clip in seconds (the reference's file-length batch
        multiplier, fastpitch1_1/xva_train.py:401-403), from the cached mel
        lengths where there are some; 10.0 when nothing is known."""
        from .audio_io import wav_duration

        hop, sr = self.mel_cfg.hop_length, self.mel_cfg.sample_rate
        longest = 0.0
        for it in self.items:
            p = self._cache_path(it)
            if os.path.exists(p):
                with np.load(p) as z:
                    frames = z["mel"].shape[1]
                longest = max(longest, frames * hop / sr)
            elif os.path.exists(it.wav_path):
                longest = max(longest, wav_duration(it.wav_path))
        return longest or 10.0

    def _decode(self, item: Utterance):
        """The item's samples cut to a hop multiple; None when unreadable,
        False when under 4 frames (skipped, kept)."""
        from .audio_io import load_wav

        try:
            y, _ = load_wav(item.wav_path, target_sr=self.mel_cfg.sample_rate)
        except Exception:  # noqa: BLE001 — an unreadable file is healed, not fatal
            return None
        hop = self.mel_cfg.hop_length
        y = y[: len(y) // hop * hop]
        return y if len(y) >= hop * 4 else False

    def build(self, progress: Optional[Callable[[int, int], None]] = None) -> None:
        """Featurize every item not yet cached, then pack the cache.

        Items are decoded by a thread pool, ``DECODE_CHUNK`` at a time; the
        unreadable ones are healed on this thread; each chunk is featurized by
        ``featurize_batch(mode="mel")`` on ``self.device`` (groups of at most
        8 clips a spectrogram call). Any failure raises."""
        from .. import resolve_device
        from ..ops.features import featurize_batch

        dev = resolve_device(self.device)
        todo = [it for it in self.items if not os.path.exists(self._cache_path(it))]
        variant = sticky_mel_variant(self.cache_dir, "pallas" if self.use_pallas else "fft")
        self.use_pallas = variant == "pallas"
        secs = {"decode": 0.0, "featurize": 0.0, "write": 0.0, "pack": 0.0}
        done = 0
        if todo:
            with ThreadPoolExecutor(max_workers=max(2, os.cpu_count() or 2)) as ex:
                for c0 in range(0, len(todo), DECODE_CHUNK):
                    t0 = time.perf_counter()
                    chunk_items = todo[c0: c0 + DECODE_CHUNK]
                    decoded = list(ex.map(self._decode, chunk_items))
                    for it, y in zip(chunk_items, decoded):
                        if y is None:
                            heal_corrupt_item(self, it)
                    good = [(it, y) for it, y in zip(chunk_items, decoded)
                            if y is not None and y is not False]
                    t1 = time.perf_counter()
                    feats = featurize_batch([y for _, y in good], self.mel_cfg, mode="mel",
                                            device=dev)
                    t2 = time.perf_counter()
                    for (item, y), f in zip(good, feats):
                        atomic_savez(self._cache_path(item), mel=f["mel"], pitch=f["pitch"],
                                     energy=f["energy"],
                                     tokens=np.asarray(self.text_to_ids(item.text), np.int32),
                                     wav_len=np.int32(len(y)))
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
        from .packed import PackedReader, pack_cache

        pack_cache(self.cache_dir)
        self._packed = PackedReader(self.cache_dir)

    def load_item(self, item: Utterance) -> Optional[Dict[str, np.ndarray]]:
        """The item's arrays: the pack's, unless its npz was rewritten after
        the pack was built."""
        p = self._cache_path(item)
        if self._packed and item.item_id in self._packed:
            try:
                npz_newer = os.path.getmtime(p) > self._packed.pack_mtime
            except OSError:
                npz_newer = False
            if not npz_newer:
                return self._packed.load(item.item_id)
        if not os.path.exists(p):
            return None
        with np.load(p) as z:
            return {k: z[k] for k in z.files}

    def pitch_stats(self) -> Dict[str, float]:
        """Dataset-level voiced-pitch mean/std (reference
        get_or_calculate_pitch_stats, fastpitch1_1/xva_train.py:493-536),
        cached to pitch_stats.json."""
        stats_path = os.path.join(self.cache_dir, "pitch_stats.json")
        if os.path.exists(stats_path):
            with open(stats_path) as f:
                return json.load(f)
        vals = []
        for it in self.items:
            d = self.load_item(it)
            if d is None:
                continue
            v = d["pitch"][d["pitch"] > 0]
            if len(v):
                vals.append(v)
        allv = np.concatenate(vals) if vals else np.zeros(1)
        stats = {"mean": float(allv.mean()), "std": float(allv.std() + 1e-8)}
        with open(stats_path, "w") as f:
            json.dump(stats, f)
        return stats


DEFAULT_BUCKETS = (
    Bucket(64, 256),
    Bucket(96, 384),
    Bucket(128, 512),
    Bucket(192, 768),
    Bucket(256, 896),
)


def zero_batch(b: Bucket, batch_size: int, n_mels: int = 80, half_feed: bool = True,
               with_prior: bool = False, with_durs: bool = False) -> Dict[str, np.ndarray]:
    """An all-zeros batch with exactly the shapes and dtypes that
    ``BucketBatcher.collate`` emits for bucket ``b`` (lengths 1, as collate's
    ``np.maximum(lens, 1)`` makes them)."""
    feat_dt = np.float16 if half_feed else np.float32
    batch = {
        "tokens": np.zeros((batch_size, b.text_len), np.int32),
        "mel": np.zeros((batch_size, b.mel_len, n_mels), feat_dt),
        "pitch": np.zeros((batch_size, 1, b.mel_len), feat_dt),
        "energy": np.zeros((batch_size, b.mel_len), feat_dt),
        "in_lens": np.ones((batch_size,), np.int32),
        "mel_lens": np.ones((batch_size,), np.int32),
        "ids": [],
    }
    if with_prior:
        batch["prior"] = np.zeros((batch_size, b.mel_len, b.text_len), np.float32)
    if with_durs:
        batch["durs"] = np.zeros((batch_size, b.text_len), np.float32)
    return batch


class BucketBatcher:
    """Static-shape batches: each batch padded to one of a few bucket shapes
    (replaces the reference's sort-by-length dynamic padding,
    python/xvapitch/dataset.py:391-401). Every batch holds ``batch_size``
    rows; the rows past a short chunk are all zero (lengths 1).

    - ``half_feed``: mel, pitch and energy as float16 (the step casts them
      up before any math);
    - ``with_prior``: the host beta-binomial prior, for a step that does not
      make it on the device;
    - ``use_durs`` (set once durations are extracted): ``"durs"`` from the
      cache's ``durs/``; an item without them gets uniform durations when
      neither the host nor the device makes a prior, else the batch has no
      ``"durs"``;
    - ``arpabet_encoder``: a ``TextProcessor(p_arpabet=0.3)`` that re-encodes
      every text each epoch (the reference's ARPAbet mix,
      fastpitch1_1/xva_train.py:307)."""

    def __init__(self, cache: FeatureCache, batch_size: int,
                 buckets: Sequence[Bucket] = DEFAULT_BUCKETS, seed: int = 0,
                 with_prior: bool = True, pitch_normalize: bool = True, drop_last: bool = False,
                 device_prior: bool = False, half_feed: bool = True):
        from .prior import BetaBinomialInterpolator

        self.cache = cache
        self.batch_size = batch_size
        self.half_feed = half_feed
        self.buckets = sorted(buckets, key=lambda b: b.mel_len)
        self.rng = np.random.default_rng(seed)
        self.with_prior = with_prior
        self._prior = BetaBinomialInterpolator()
        stats = cache.pitch_stats() if pitch_normalize else None
        self.pitch_mean = stats["mean"] if stats else 0.0
        self.pitch_std = stats["std"] if stats else 1.0
        self.pitch_normalize = pitch_normalize
        self.drop_last = drop_last
        self.device_prior = device_prior
        self.use_durs = False
        self.arpabet_encoder = None

        # each item in the first bucket that holds its tokens and frames
        self.assignment: Dict[Bucket, List[Utterance]] = {b: [] for b in self.buckets}
        self.skipped = 0
        for it in cache.items:
            d = cache.load_item(it)
            if d is None:
                continue
            tl, ml = len(d["tokens"]), d["mel"].shape[1]
            for b in self.buckets:
                if tl <= b.text_len and ml <= b.mel_len:
                    self.assignment[b].append(it)
                    break
            else:
                self.skipped += 1

    def __len__(self):
        n = 0
        for items in self.assignment.values():
            if self.drop_last:
                n += len(items) // self.batch_size
            else:
                n += (len(items) + self.batch_size - 1) // self.batch_size
        return n

    def epoch(self, shuffle: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """One pass: each bucket's items shuffled, cut into batches, the
        batches shuffled (JAX's draws, in JAX's order)."""
        plans = []
        for b, items in self.assignment.items():
            if not items:
                continue
            order = list(items)
            if shuffle:
                self.rng.shuffle(order)
            for s in range(0, len(order), self.batch_size):
                chunk = order[s: s + self.batch_size]
                if self.drop_last and len(chunk) < self.batch_size:
                    continue
                plans.append((b, chunk))
        if shuffle:
            self.rng.shuffle(plans)
        for b, chunk in plans:
            yield self.collate(b, chunk)

    def collate(self, b: Bucket, chunk: List[Utterance]) -> Dict[str, np.ndarray]:
        from .pitch import normalize_pitch

        n = self.batch_size
        feat_dt = np.float16 if self.half_feed else np.float32
        tokens = np.zeros((n, b.text_len), np.int32)
        mel = np.zeros((n, b.mel_len, self.cache.mel_cfg.n_mels), feat_dt)
        pitch = np.zeros((n, 1, b.mel_len), feat_dt)
        energy = np.zeros((n, b.mel_len), feat_dt)
        in_lens = np.zeros((n,), np.int32)
        mel_lens = np.zeros((n,), np.int32)
        prior = np.zeros((n, b.mel_len, b.text_len), np.float32) if self.with_prior else None
        ids = []
        for i, it in enumerate(chunk):
            d = self.cache.load_item(it)
            toks = d["tokens"]
            if self.arpabet_encoder is not None:
                mixed = self.arpabet_encoder.encode(it.text)
                if len(mixed):
                    toks = mixed
            tl = min(len(toks), b.text_len)
            ml = min(d["mel"].shape[1], b.mel_len)
            tokens[i, :tl] = toks[:tl]
            mel[i, :ml] = d["mel"][:, :ml].T
            p = d["pitch"][:ml]
            if self.pitch_normalize:
                p = normalize_pitch(p, self.pitch_mean, self.pitch_std)
            pitch[i, 0, :ml] = p
            energy[i, :ml] = d["energy"][:ml]
            in_lens[i] = tl
            mel_lens[i] = ml
            if self.with_prior:
                prior[i, :ml, :tl] = self._prior(ml, tl)
            ids.append(it.item_id)
        batch = {"tokens": tokens, "mel": mel, "pitch": pitch, "energy": energy,
                 "in_lens": np.maximum(in_lens, 1), "mel_lens": np.maximum(mel_lens, 1),
                 "ids": ids}
        if self.with_prior:
            batch["prior"] = prior
        if self.use_durs:
            durs = np.zeros((n, b.text_len), np.float32)
            complete = True
            for i, it in enumerate(chunk):
                d = self.cache.load_durations(it.item_id)
                if d is None:
                    if not self.with_prior and not self.device_prior:
                        # neither the host nor the step makes a prior, so the
                        # aligner cannot run: uniform durations for this item
                        tl, ml = int(in_lens[i]), int(mel_lens[i])
                        durs[i, :tl] = ml / max(tl, 1)
                        continue
                    complete = False
                    break
                tl = min(len(d), b.text_len)
                durs[i, :tl] = d[:tl]
            if complete:
                batch["durs"] = durs
        return batch
