"""ctypes bindings to the system libvorbis/libvorbisfile/libvorbisenc.

The port's copy of ``xva_trainer_tpu/native/vorbis.py``.

Used by the wem2ogg tool (tools/wwise_vorbis.py) to decode the rebuilt Ogg
Vorbis streams to PCM — the reference leaves decoding to the user's player
after ww2ogg.exe produces the .ogg (python/wem2ogg/model.py:36-64); we go the
extra step so Vorbis .wem feeds straight into the dataset pipeline. The
encoder half exists for round-trip tests and for writing .ogg previews.

All structs the libraries own are treated as opaque blobs (oversized
buffers); only ``ogg_packet``/``ogg_page``/``vorbis_info`` fields that we
must read or write are declared. Everything degrades to ``available() ==
False`` when the shared libraries are missing.
"""
from __future__ import annotations

import ctypes
import ctypes.util
from typing import List, Optional, Tuple

import numpy as np

c_float_pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))


class ogg_packet(ctypes.Structure):
    _fields_ = [
        ("packet", ctypes.POINTER(ctypes.c_ubyte)),
        ("bytes", ctypes.c_long),
        ("b_o_s", ctypes.c_long),
        ("e_o_s", ctypes.c_long),
        ("granulepos", ctypes.c_int64),
        ("packetno", ctypes.c_int64),
    ]


class vorbis_info(ctypes.Structure):
    _fields_ = [
        ("version", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("rate", ctypes.c_long),
        # bitrate fields + codec_setup pointer follow; opaque padding keeps
        # the struct at least as large as the library's definition.
        ("_pad", ctypes.c_byte * 256),
    ]


_libs: Optional[Tuple] = None
_tried = False


def _load():
    global _libs, _tried
    if _libs is not None or _tried:
        return _libs
    _tried = True
    try:
        # RTLD_GLOBAL: libvorbisenc/-file resolve libvorbis symbols
        vorbis = ctypes.CDLL("libvorbis.so.0", mode=ctypes.RTLD_GLOBAL)
        vfile = ctypes.CDLL("libvorbisfile.so.3", mode=ctypes.RTLD_GLOBAL)
        venc = ctypes.CDLL("libvorbisenc.so.2", mode=ctypes.RTLD_GLOBAL)
    except OSError:
        return None

    vfile.ov_fopen.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    vfile.ov_fopen.restype = ctypes.c_int
    vfile.ov_info.argtypes = [ctypes.c_void_p, ctypes.c_int]
    vfile.ov_info.restype = ctypes.POINTER(vorbis_info)
    vfile.ov_pcm_total.argtypes = [ctypes.c_void_p, ctypes.c_int]
    vfile.ov_pcm_total.restype = ctypes.c_int64
    vfile.ov_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_int)]
    vfile.ov_read.restype = ctypes.c_long
    vfile.ov_clear.argtypes = [ctypes.c_void_p]

    venc.vorbis_encode_init_vbr.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_float]
    venc.vorbis_encode_init_vbr.restype = ctypes.c_int

    vorbis.vorbis_analysis_buffer.argtypes = [ctypes.c_void_p, ctypes.c_int]
    vorbis.vorbis_analysis_buffer.restype = c_float_pp
    for name in ("vorbis_analysis_wrote", "vorbis_analysis_blockout",
                 "vorbis_bitrate_flushpacket"):
        getattr(vorbis, name).restype = ctypes.c_int

    _libs = (vorbis, vfile, venc)
    return _libs


def available() -> bool:
    return _load() is not None


def decode_ogg(path: str) -> Optional[Tuple[np.ndarray, int]]:
    """Decode an Ogg Vorbis file to (mono float32 in [-1, 1], sample_rate).
    Returns None when libvorbisfile is unavailable; raises ValueError on a
    corrupt stream."""
    libs = _load()
    if libs is None:
        return None
    _, vfile, _ = libs
    ovf = ctypes.create_string_buffer(2048)  # sizeof(OggVorbis_File) ~ 944
    rc = vfile.ov_fopen(path.encode(), ovf)
    if rc != 0:
        raise ValueError(f"libvorbisfile rejected the stream (rc={rc})")
    try:
        vi = vfile.ov_info(ovf, -1).contents
        channels, rate = vi.channels, int(vi.rate)
        chunks = []
        buf = ctypes.create_string_buffer(65536)
        bitstream = ctypes.c_int(0)
        while True:
            n = vfile.ov_read(ovf, buf, len(buf), 0, 2, 1,
                              ctypes.byref(bitstream))
            if n == 0:
                break
            if n < 0:  # hole in data: skip (matches vorbisfile tooling)
                continue
            chunks.append(np.frombuffer(buf.raw[:n], np.int16).copy())
    finally:
        vfile.ov_clear(ovf)
    if not chunks:
        return np.zeros(0, np.float32), rate
    pcm = np.concatenate(chunks).astype(np.float32) / 32768.0
    if channels > 1:
        pcm = pcm[: len(pcm) // channels * channels]
        pcm = pcm.reshape(-1, channels).mean(axis=1)
    return pcm, rate


def encode_ogg_packets(pcm: np.ndarray, sr: int, quality: float = 0.4
                       ) -> Optional[Tuple[List[bytes],
                                           List[Tuple[bytes, int]]]]:
    """Encode mono float32 PCM to raw Vorbis packets.

    Returns ([id, comment, setup], [(audio_packet, granulepos), ...]) or
    None when libvorbisenc is unavailable. Raw packets (not an Ogg stream):
    the wem fixtures and the Ogg writer both work at packet granularity.
    """
    libs = _load()
    if libs is None:
        return None
    vorbis, _, venc = libs

    vi = ctypes.create_string_buffer(512)    # vorbis_info
    vc = ctypes.create_string_buffer(512)    # vorbis_comment
    vd = ctypes.create_string_buffer(8192)   # vorbis_dsp_state
    vb = ctypes.create_string_buffer(8192)   # vorbis_block

    vorbis.vorbis_info_init(vi)
    try:
        if venc.vorbis_encode_init_vbr(vi, 1, sr, ctypes.c_float(quality)):
            raise ValueError("vorbis_encode_init_vbr failed")
        vorbis.vorbis_comment_init(vc)
        if vorbis.vorbis_analysis_init(vd, vi):
            raise ValueError("vorbis_analysis_init failed")
        vorbis.vorbis_block_init(vd, vb)

        op, op2, op3 = ogg_packet(), ogg_packet(), ogg_packet()
        vorbis.vorbis_analysis_headerout(vd, vc, ctypes.byref(op),
                                         ctypes.byref(op2), ctypes.byref(op3))
        headers = [ctypes.string_at(p.packet, p.bytes) for p in (op, op2, op3)]

        audio: List[Tuple[bytes, int]] = []

        def drain():
            while vorbis.vorbis_analysis_blockout(vd, vb) == 1:
                vorbis.vorbis_analysis(vb, None)
                vorbis.vorbis_bitrate_addblock(vb)
                pkt = ogg_packet()
                while vorbis.vorbis_bitrate_flushpacket(
                        vd, ctypes.byref(pkt)) == 1:
                    audio.append((ctypes.string_at(pkt.packet, pkt.bytes),
                                  int(pkt.granulepos)))

        pcm = np.ascontiguousarray(pcm, np.float32)
        pos = 0
        while pos < len(pcm):
            n = min(4096, len(pcm) - pos)
            bufpp = vorbis.vorbis_analysis_buffer(vd, n)
            ctypes.memmove(bufpp[0], pcm[pos:pos + n].ctypes.data, n * 4)
            vorbis.vorbis_analysis_wrote(vd, n)
            drain()
            pos += n
        vorbis.vorbis_analysis_wrote(vd, 0)
        drain()

        vorbis.vorbis_block_clear(vb)
        vorbis.vorbis_dsp_clear(vd)
        vorbis.vorbis_comment_clear(vc)
        return headers, audio
    finally:
        vorbis.vorbis_info_clear(vi)
