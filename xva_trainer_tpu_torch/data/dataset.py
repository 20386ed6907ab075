"""Dataset metadata, the corrupt-item list, atomic npz writes, the
spectrogram-variant pin and the bucket shape of the v3 feature cache.

The port's copy of the v3 part of ``xva_trainer_tpu/data/dataset.py``.
``metadata.csv`` holds ``<wav filename>|<transcript>[|...]`` one per line,
with the wavs under ``wavs/`` (reference python/xvapitch/dataset.py
read_datasets). The v2 ``FeatureCache``, ``BucketBatcher`` and
``zero_batch`` are not ported yet.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List

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
