"""The port's host library: the FLAC decoder, bound with ctypes.

Counterpart of ``xva_trainer_tpu/native/__init__.py`` for ``decode_flac``
and ``available``. The port decodes and resamples wavs with scipy
(``data/audio_io.py``), so the JAX library's wav decode, resampler, YIN,
silence scan and loudness have no counterpart here.

``csrc/flac_decode.cpp`` is compiled by the host C++ compiler at first use
into ``build/host/libflac_decode-<hash>.so`` (the hash is of the source, so
an edited decoder is rebuilt), as ``ops/_cuda.py`` builds the CUDA kernels.
Nothing is built when this module is imported. A failed build raises; a
stream the decoder rejects gives ``None``, and the caller goes on to ffmpeg.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "flac_decode.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _compiler() -> Optional[str]:
    return os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libflac_decode-{digest}.so"


def build() -> str:
    """Compile ``csrc/flac_decode.cpp`` unless it is built already. Returns
    the compiler's output, or "" when nothing was built; raises on a failed
    build or when no compiler is found."""
    out = library_path()
    if out.exists():
        return ""
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++): the FLAC decoder cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, check=False)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"build of the FLAC decoder failed ({cxx} exit "
                           f"{proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a process building it too loads a whole library
    return log


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed (raises if it cannot be)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(library_path()))
            c_float_p = ctypes.POINTER(ctypes.c_float)
            lib.xva_decode_flac.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(c_float_p),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ]
            lib.xva_decode_flac.restype = ctypes.c_int
            lib.xva_free.argtypes = [c_float_p]
            lib.xva_free.restype = None
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the decoder is built or a compiler is there to build it."""
    return _lib is not None or library_path().exists() or _compiler() is not None


def decode_flac(path: str) -> Optional[Tuple[np.ndarray, int]]:
    """FLAC → (mono float32, sr); ``None`` when the decoder rejects the
    stream (a corrupt or unsupported file)."""
    lib = get_lib()
    buf = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int()
    sr = ctypes.c_int()
    rc = lib.xva_decode_flac(os.fsencode(path), ctypes.byref(buf),
                             ctypes.byref(n), ctypes.byref(sr))
    if rc != 0:
        return None
    try:
        y = np.ctypeslib.as_array(buf, shape=(n.value,)).copy()
    finally:
        lib.xva_free(buf)
    return y, sr.value
