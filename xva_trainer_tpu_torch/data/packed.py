"""Packed binary feature cache: one mmap'd file instead of an npz per item.

The port's copy of ``xva_trainer_tpu/data/packed.py``, byte for byte the same
format, so that a pack written by either package is read by the other: every
item's arrays as raw little-endian bytes in ``packed.bin``, each 64-byte
aligned, and ``packed_index.json`` with each array's dtype, shape, offset and
size, the stamp (npz names and mtimes) and the bin's size. ``PackedReader``
serves zero-copy mmap views and refuses an index that does not match its bin.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

PACK_BIN = "packed.bin"
PACK_IDX = "packed_index.json"
_ALIGN = 64


def _cache_files(cache_dir: str) -> List[str]:
    return sorted(
        f for f in os.listdir(cache_dir) if f.endswith(".npz")
    )


def pack_cache(cache_dir: str) -> Optional[str]:
    """Pack every ``<item_id>.npz`` in ``cache_dir`` into packed.bin + index.

    Returns the index path, or None if there is nothing to pack. Safe to
    re-run: rewrites the pack only when the set of npz files changed.
    """
    files = _cache_files(cache_dir)
    if not files:
        return None
    idx_path = os.path.join(cache_dir, PACK_IDX)
    bin_path_check = os.path.join(cache_dir, PACK_BIN)
    stamp = [(f, os.path.getmtime(os.path.join(cache_dir, f))) for f in files]
    if os.path.exists(idx_path):
        try:
            with open(idx_path) as fh:
                old = json.load(fh)
            # up to date only if the bin still exists AND is the one this
            # index was written for (a crash between the two os.replace
            # calls below, or a deleted bin, must trigger a rebuild — a
            # stale index silently maps into wrong bytes otherwise)
            if (old.get("stamp") == [[f, m] for f, m in stamp]
                    and os.path.exists(bin_path_check)
                    and os.path.getsize(bin_path_check)
                    == old.get("bin_size")):
                return idx_path
        except (json.JSONDecodeError, OSError):
            pass
    index: Dict[str, Dict] = {}
    bin_path = os.path.join(cache_dir, PACK_BIN)
    tmp_bin = bin_path + ".tmp"
    off = 0
    with open(tmp_bin, "wb") as out:
        for f in files:
            item_id = f[: -len(".npz")]
            entry = {}
            try:
                with np.load(os.path.join(cache_dir, f)) as z:
                    arrays = {k: np.ascontiguousarray(z[k]) for k in z.files}
            except (OSError, ValueError):
                continue  # unreadable npz: leave it to the healing path
            for k, a in arrays.items():
                pad = (-off) % _ALIGN
                if pad:
                    out.write(b"\0" * pad)
                    off += pad
                entry[k] = [a.dtype.str, list(a.shape), off, int(a.nbytes)]
                out.write(a.tobytes())
                off += a.nbytes
            index[item_id] = entry
    os.replace(tmp_bin, bin_path)
    tmp_idx = idx_path + ".tmp"
    with open(tmp_idx, "w") as fh:
        json.dump({"stamp": [[f, m] for f, m in stamp], "bin_size": off,
                   "items": index}, fh)
    os.replace(tmp_idx, idx_path)
    return idx_path


class PackedReader:
    """mmap-backed reader over a pack built by :func:`pack_cache`.

    ``load`` returns read-only zero-copy views; callers that mutate must copy
    (the batchers copy into padded buffers anyway).
    """

    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        idx_path = os.path.join(cache_dir, PACK_IDX)
        bin_path = os.path.join(cache_dir, PACK_BIN)
        self.index: Dict[str, Dict] = {}
        self._buf = None
        self.pack_mtime: float = 0.0
        if not (os.path.exists(idx_path) and os.path.exists(bin_path)):
            return
        try:
            self.pack_mtime = os.path.getmtime(idx_path)
            with open(idx_path) as fh:
                meta = json.load(fh)
            buf = np.memmap(bin_path, dtype=np.uint8, mode="r")
            # reject an index/bin pair that disagrees (interrupted
            # pack_cache): offsets from the old index into a new bin would
            # return wrong feature bytes silently
            if ("bin_size" in meta and meta["bin_size"] != buf.size):
                raise KeyError("packed index does not match packed.bin")
            self.index = meta["items"]
            self._buf = buf
        except (json.JSONDecodeError, OSError, KeyError):
            self.index = {}
            self._buf = None

    def __bool__(self) -> bool:
        return self._buf is not None and bool(self.index)

    def __contains__(self, item_id: str) -> bool:
        return item_id in self.index

    def load(self, item_id: str) -> Optional[Dict[str, np.ndarray]]:
        entry = self.index.get(item_id)
        if entry is None or self._buf is None:
            return None
        out = {}
        for k, (dtype, shape, off, nbytes) in entry.items():
            if off + nbytes > self._buf.size:
                return None  # truncated pack: caller falls back to the npz
            a = np.frombuffer(self._buf, dtype=np.dtype(dtype),
                              count=int(np.prod(shape, dtype=np.int64)),
                              offset=off)
            out[k] = a.reshape(shape)
        return out
