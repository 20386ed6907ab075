"""Native Wwise-Vorbis ``.wem`` → Ogg Vorbis conversion (no external binary).

The port's copy of ``xva_trainer_tpu/tools/wwise_vorbis.py`` (pure Python;
the codebook library is the port's own copy in ``assets/``).

The reference ships a prebuilt ``ww2ogg.exe`` + ``packed_codebooks_aoTuV_603.bin``
and shells out to it (reference python/wem2ogg/model.py:36-64). This
module implements the conversion natively: Audiokinetic's Wwise encoder stores
standard Vorbis *audio* data but strips the container down —

- the three Vorbis header packets are replaced by a tiny ``vorb`` metadata
  struct (or, in 2009-era files, kept verbatim as a "header triad");
- the setup header's codebooks are replaced by 10-bit ids into an external
  codebook library (the aoTuV 6.03 static codebooks, shipped as
  ``assets/packed_codebooks_aoTuV_603.bin``), or stored inline in 2010-era
  files;
- floor/residue/mapping/mode configs are stored in a stripped form (type
  fields and other spec-constant bits removed);
- audio packets lose their 2-byte framing (packet-type bit + long-block
  window flags) in "mod packets" mode.

Conversion is the inverse: parse the RIFF/vorb layout, re-inflate the setup
header bit-for-bit into spec Vorbis, re-frame the audio packets, and write a
standard Ogg container (page lacing + the Ogg CRC-32). All bit IO is
LSB-first within each byte, as the Vorbis I spec requires.

Layout/quirk knowledge (vorb-size dispatch, the mod-signal exception list,
the packed codebook entry format) follows the behavior of the public ww2ogg
(Adam Gashlin, BSD-licensed — see assets/packed_codebooks_LICENSE.txt) and
vgmstream's Wwise support; the implementation here is original.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")
DEFAULT_CODEBOOKS = os.path.join(ASSET_DIR, "packed_codebooks_aoTuV_603.bin")


class WemParseError(ValueError):
    pass


# --------------------------------------------------------------------------
# LSB-first bit IO (Vorbis bitpacking convention)
# --------------------------------------------------------------------------

class BitReader:
    """Reads LSB-first within each byte, over a bytes-like buffer."""

    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.nbits = len(data) * 8

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        if self.pos + n > self.nbits:
            raise WemParseError("bitstream overrun")
        start = self.pos >> 3
        end = (self.pos + n + 7) >> 3
        chunk = int.from_bytes(self.data[start:end], "little")
        v = (chunk >> (self.pos & 7)) & ((1 << n) - 1)
        self.pos += n
        return v

    def remaining(self) -> int:
        return self.nbits - self.pos


class BitWriter:
    """Accumulates LSB-first bits; ``bytes()`` zero-pads the tail."""

    __slots__ = ("buf", "acc", "accbits")

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.accbits = 0

    def write(self, value: int, n: int) -> None:
        if n == 0:
            return
        self.acc |= (value & ((1 << n) - 1)) << self.accbits
        self.accbits += n
        if self.accbits >= 8:
            whole = self.accbits >> 3
            self.buf += (self.acc & ((1 << (whole * 8)) - 1)).to_bytes(
                whole, "little")
            self.acc >>= whole * 8
            self.accbits &= 7

    def write_bytes(self, raw: bytes) -> None:
        if self.accbits == 0:
            self.buf += raw
        else:
            self.write(int.from_bytes(raw, "little"), len(raw) * 8)

    def to_bytes(self) -> bytes:
        out = bytes(self.buf)
        if self.accbits:
            out += bytes([self.acc & 0xFF])
        return out

    def bit_length(self) -> int:
        return len(self.buf) * 8 + self.accbits


def copy_bits(br: BitReader, bw: BitWriter, n: int) -> None:
    while n > 0:
        take = min(n, 4096)
        bw.write(br.read(take), take)
        n -= take


def ilog(x: int) -> int:
    """Bits needed to represent x (Vorbis spec ilog; ilog(0) == 0)."""
    n = 0
    while x > 0:
        n += 1
        x >>= 1
    return n


def book_maptype1_quantvals(entries: int, dims: int) -> int:
    """Largest v with v**dims <= entries (libvorbis _book_maptype1_quantvals)."""
    if dims == 0:
        return 0
    vals = int(round(entries ** (1.0 / dims)))
    while True:
        acc = vals ** dims
        acc1 = (vals + 1) ** dims
        if acc <= entries and acc1 > entries:
            return vals
        if acc > entries:
            vals -= 1
        else:
            vals += 1


# --------------------------------------------------------------------------
# Codebooks
# --------------------------------------------------------------------------

def rebuild_packed_codebook(br: BitReader, bw: BitWriter) -> None:
    """Re-inflate one packed-library codebook into spec Vorbis form.

    Packed form drops the 24-bit sync pattern, narrows the dimension/entry
    count fields, and stores codeword lengths in a variable-width field
    (3-bit width prefix) instead of fixed 5 bits.
    """
    dimensions = br.read(4)
    entries = br.read(14)
    bw.write(0x564342, 24)  # codebook sync pattern "BCV"
    bw.write(dimensions, 16)
    bw.write(entries, 24)

    ordered = br.read(1)
    bw.write(ordered, 1)
    if ordered:
        initial_length = br.read(5)
        bw.write(initial_length, 5)
        current = 0
        while current < entries:
            n = ilog(entries - current)
            number = br.read(n)
            bw.write(number, n)
            current += number
        if current > entries:
            raise WemParseError("ordered codebook overflows entry count")
    else:
        codeword_length_length = br.read(3)
        sparse = br.read(1)
        if codeword_length_length == 0 or codeword_length_length > 5:
            raise WemParseError("bad codeword length width")
        bw.write(sparse, 1)
        for _ in range(entries):
            present = True
            if sparse:
                flag = br.read(1)
                bw.write(flag, 1)
                present = bool(flag)
            if present:
                length = br.read(codeword_length_length)
                bw.write(length, 5)

    lookup_type = br.read(1)
    bw.write(lookup_type, 4)
    if lookup_type == 0:
        pass
    elif lookup_type == 1:
        bw.write(br.read(32), 32)  # minimum_value
        bw.write(br.read(32), 32)  # delta_value
        value_length = br.read(4)
        bw.write(value_length, 4)
        bw.write(br.read(1), 1)  # sequence_p
        quantvals = book_maptype1_quantvals(entries, dimensions)
        for _ in range(quantvals):
            bw.write(br.read(value_length + 1), value_length + 1)
    else:
        raise WemParseError(f"packed codebook lookup type {lookup_type}")


def copy_vorbis_codebook(br: BitReader, bw: BitWriter) -> None:
    """Parse-and-copy one codebook already in spec Vorbis form (inline
    codebooks, 2010-era wems). Parsing is required because the codebook has
    no explicit length — its end is found by walking the structure."""
    if br.read(24) != 0x564342:
        raise WemParseError("inline codebook lost sync")
    bw.write(0x564342, 24)
    dimensions = br.read(16)
    entries = br.read(24)
    bw.write(dimensions, 16)
    bw.write(entries, 24)

    ordered = br.read(1)
    bw.write(ordered, 1)
    if ordered:
        bw.write(br.read(5), 5)
        current = 0
        while current < entries:
            n = ilog(entries - current)
            number = br.read(n)
            bw.write(number, n)
            current += number
    else:
        sparse = br.read(1)
        bw.write(sparse, 1)
        for _ in range(entries):
            present = True
            if sparse:
                flag = br.read(1)
                bw.write(flag, 1)
                present = bool(flag)
            if present:
                bw.write(br.read(5), 5)

    lookup_type = br.read(4)
    bw.write(lookup_type, 4)
    if lookup_type == 0:
        return
    if lookup_type not in (1, 2):
        raise WemParseError(f"codebook lookup type {lookup_type}")
    bw.write(br.read(32), 32)
    bw.write(br.read(32), 32)
    value_length = br.read(4)
    bw.write(value_length, 4)
    bw.write(br.read(1), 1)
    count = (book_maptype1_quantvals(entries, dimensions)
             if lookup_type == 1 else entries * dimensions)
    for _ in range(count):
        bw.write(br.read(value_length + 1), value_length + 1)


class CodebookLibrary:
    """External packed-codebook library (``packed_codebooks_aoTuV_603.bin``).

    File layout: concatenated packed codebooks, then a table of u32-LE
    offsets; the final u32 of the file points at the table itself, so the
    table's last entry (== the table offset) terminates the data region.
    """

    def __init__(self, path: str = DEFAULT_CODEBOOKS):
        with open(path, "rb") as f:
            data = f.read()
        if len(data) < 8:
            raise WemParseError("codebook library too small")
        table_off = struct.unpack_from("<I", data, len(data) - 4)[0]
        n = (len(data) - table_off) // 4
        if table_off + 4 * n > len(data) or n < 2:
            raise WemParseError("corrupt codebook library offset table")
        offsets = struct.unpack_from(f"<{n}I", data, table_off)
        self.data = data
        self.offsets = offsets
        self.count = n - 1  # last table entry terminates the data region

    def get(self, cb_id: int) -> bytes:
        if not (0 <= cb_id < self.count):
            raise WemParseError(f"codebook id {cb_id} outside library "
                                f"(0..{self.count - 1})")
        return self.data[self.offsets[cb_id]:self.offsets[cb_id + 1]]

    def rebuild(self, cb_id: int, bw: BitWriter) -> None:
        raw = self.get(cb_id)
        br = BitReader(raw)
        rebuild_packed_codebook(br, bw)
        # entries are byte-aligned; some carry a whole zero pad byte. Any
        # NONZERO trailing bits mean the structure was misparsed.
        rem = br.remaining()
        if rem >= 16 or (rem and br.read(rem) != 0):
            raise WemParseError(f"codebook {cb_id}: trailing garbage")


def write_packed_library(codebooks: List[bytes], path: str) -> None:
    """Write a codebook library file from packed-form entries (test support
    and custom game libraries)."""
    blob = bytearray()
    offsets = []
    for cb in codebooks:
        offsets.append(len(blob))
        blob += cb
    table_off = len(blob)
    for off in offsets:
        blob += struct.pack("<I", off)
    # the final u32 is dual-purpose: last table entry (terminates the data
    # region of the last codebook) AND the file-end pointer to the table —
    # matching the shipped aoTuV layout (598 books → 599 table u32s)
    blob += struct.pack("<I", table_off)
    with open(path, "wb") as f:
        f.write(bytes(blob))


# --------------------------------------------------------------------------
# wem container parsing
# --------------------------------------------------------------------------

class WemInfo:
    channels: int
    sample_rate: int
    avg_bytes_per_second: int
    sample_count: int
    setup_packet_offset: int
    first_audio_packet_offset: int
    blocksize_0_pow: int
    blocksize_1_pow: int
    data_offset: int
    data_size: int
    mod_packets: bool
    header_triad: bool
    packet_header: int  # 2 = u16 size; 6 = u16 size + u32 granule; 8 = u32+u32
    setup_mode: str     # "external" | "inline" | "triad"


def parse_wem(data: bytes) -> WemInfo:
    if len(data) < 12 or data[8:12] != b"WAVE":
        raise WemParseError("not a RIFF WAVE file")
    if data[0:4] == b"RIFX":
        raise WemParseError("big-endian (console) .wem not supported")
    if data[0:4] != b"RIFF":
        raise WemParseError("not a RIFF WAVE file")

    chunks: Dict[bytes, Tuple[int, int]] = {}
    pos = 12
    riff_end = min(len(data), 8 + struct.unpack_from("<I", data, 4)[0])
    while pos + 8 <= riff_end:
        cid = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        chunks[cid.rstrip()] = (pos + 8, size)
        pos += 8 + size + (size & 1)

    if b"fmt" not in chunks or b"data" not in chunks:
        raise WemParseError("missing fmt/data chunk")
    fmt_off, fmt_size = chunks[b"fmt"]
    (codec, channels, sample_rate, avg_bps) = struct.unpack_from(
        "<HHII", data, fmt_off)
    if codec != 0xFFFF:
        raise WemParseError(f"not a Wwise Vorbis .wem (codec 0x{codec:04X})")

    info = WemInfo()
    info.channels = channels
    info.sample_rate = sample_rate
    info.avg_bytes_per_second = avg_bps
    info.data_offset, info.data_size = chunks[b"data"]

    if b"vorb" in chunks:
        vorb_off, vorb_size = chunks[b"vorb"]
    elif fmt_size == 0x42:
        # modern layout: vorb struct embedded in the fmt extra data
        vorb_off, vorb_size = fmt_off + 0x18, 0x2A
    else:
        raise WemParseError(f"no vorb data (fmt size 0x{fmt_size:X})")

    v = data[vorb_off:vorb_off + vorb_size]
    if len(v) < 0x28:
        raise WemParseError("vorb chunk truncated")
    info.sample_count = struct.unpack_from("<I", v, 0x00)[0]
    info.header_triad = False
    info.mod_packets = False

    # field offsets differ by generation: the modern 0x2A (and fmt-embedded)
    # layout keeps setup/audio offsets at 0x10/0x14 and blocksize pows at
    # 0x28/0x29; the older 0x28/0x2C/0x32/0x34 layouts keep the offsets at
    # 0x18/0x1C (blocksizes at 0x30/0x31 where present) — per ww2ogg
    # wwriff.cpp / vgmstream's Wwise parser.
    if vorb_size == 0x2A:
        info.setup_packet_offset = struct.unpack_from("<I", v, 0x10)[0]
        info.first_audio_packet_offset = struct.unpack_from("<I", v, 0x14)[0]
        # 2011+: external codebooks, 2-byte packet headers, mod packets
        # (unless the mod-signal byte opts out)
        mod_signal = struct.unpack_from("<I", v, 0x04)[0]
        info.mod_packets = mod_signal not in (0x4A, 0x4B, 0x69, 0x70)
        info.blocksize_0_pow = v[0x28]
        info.blocksize_1_pow = v[0x29]
        info.packet_header = 2
        info.setup_mode = "external"
    elif vorb_size in (0x32, 0x34):
        info.setup_packet_offset = struct.unpack_from("<I", v, 0x18)[0]
        info.first_audio_packet_offset = struct.unpack_from("<I", v, 0x1C)[0]
        # ~2010: inline (spec-form) codebooks, 6-byte packet headers
        info.blocksize_0_pow = v[0x30]
        info.blocksize_1_pow = v[0x31]
        info.packet_header = 6
        info.setup_mode = "inline"
    elif vorb_size in (0x28, 0x2C):
        info.setup_packet_offset = struct.unpack_from("<I", v, 0x18)[0]
        info.first_audio_packet_offset = struct.unpack_from("<I", v, 0x1C)[0]
        # 2009: the three Vorbis headers are stored verbatim ("header triad")
        info.header_triad = True
        info.packet_header = 8
        info.setup_mode = "triad"
        info.blocksize_0_pow = 0  # read from the stored id header
        info.blocksize_1_pow = 0
    else:
        raise WemParseError(f"unknown vorb chunk size 0x{vorb_size:X}")
    return info


def _read_packet(data: bytes, pos: int, header: int) -> Tuple[bytes, int, int]:
    """Returns (payload, next_pos, granule_or_-1) for one size-prefixed
    Wwise packet."""
    if header == 8:
        if pos + 8 > len(data):
            raise WemParseError("packet header truncated")
        size, granule = struct.unpack_from("<II", data, pos)
        hdr = 8
    else:
        if pos + header > len(data):
            raise WemParseError("packet header truncated")
        size = struct.unpack_from("<H", data, pos)[0]
        granule = (struct.unpack_from("<I", data, pos + 2)[0]
                   if header == 6 else -1)
        hdr = header
    start = pos + hdr
    if start + size > len(data):
        raise WemParseError("packet payload truncated")
    return data[start:start + size], start + size, granule


# --------------------------------------------------------------------------
# Header generation / setup re-inflation
# --------------------------------------------------------------------------

def _common_header(packet_type: int) -> BitWriter:
    bw = BitWriter()
    bw.write(packet_type, 8)
    bw.write_bytes(b"vorbis")
    return bw


def build_id_header(info: WemInfo) -> bytes:
    bw = _common_header(1)
    bw.write(0, 32)                 # vorbis_version
    bw.write(info.channels, 8)
    bw.write(info.sample_rate, 32)
    bw.write(0, 32)                 # bitrate_maximum
    bw.write(info.avg_bytes_per_second * 8, 32)   # bitrate_nominal
    bw.write(0, 32)                 # bitrate_minimum
    bw.write(info.blocksize_0_pow, 4)
    bw.write(info.blocksize_1_pow, 4)
    bw.write(1, 1)                  # framing
    return bw.to_bytes()


def build_comment_header(vendor: bytes = b"xva_trainer_tpu wem2ogg") -> bytes:
    bw = _common_header(3)
    bw.write(len(vendor), 32)
    bw.write_bytes(vendor)
    bw.write(0, 32)                 # user_comment_count
    bw.write(1, 1)
    return bw.to_bytes()


def rebuild_setup_header(payload: bytes, info: WemInfo,
                         library: Optional[CodebookLibrary]
                         ) -> Tuple[bytes, List[bool]]:
    """Re-inflate the stripped Wwise setup packet into a spec Vorbis setup
    header. Returns (header_bytes, mode_blockflags) — the blockflags drive
    audio-packet re-framing and granule computation."""
    br = BitReader(payload)
    bw = _common_header(5)

    codebook_count = br.read(8) + 1
    bw.write(codebook_count - 1, 8)
    if info.setup_mode == "external":
        if library is None:
            raise WemParseError("external-codebook .wem needs the codebook "
                                "library (packed_codebooks_aoTuV_603.bin)")
        for _ in range(codebook_count):
            library.rebuild(br.read(10), bw)
    else:
        for _ in range(codebook_count):
            copy_vorbis_codebook(br, bw)

    # time-domain transforms: spec-constant placeholder, absent in the wem
    bw.write(0, 6)
    bw.write(0, 16)

    # floors (always floor type 1; the 16-bit type field is stripped)
    floor_count = br.read(6) + 1
    bw.write(floor_count - 1, 6)
    for _ in range(floor_count):
        bw.write(1, 16)  # floor_type
        partitions = br.read(5)
        bw.write(partitions, 5)
        class_list = []
        for _ in range(partitions):
            c = br.read(4)
            bw.write(c, 4)
            class_list.append(c)
        max_class = max(class_list) if class_list else -1
        class_dims = []
        for _ in range(max_class + 1):
            dims = br.read(3) + 1
            bw.write(dims - 1, 3)
            class_dims.append(dims)
            subclasses = br.read(2)
            bw.write(subclasses, 2)
            if subclasses:
                masterbook = br.read(8)
                bw.write(masterbook, 8)
                if masterbook >= codebook_count:
                    raise WemParseError("floor masterbook out of range")
            for _ in range(1 << subclasses):
                book_plus1 = br.read(8)
                bw.write(book_plus1, 8)
                if book_plus1 > codebook_count:
                    raise WemParseError("floor subclass book out of range")
        bw.write(br.read(2), 2)      # floor1_multiplier - 1
        rangebits = br.read(4)
        bw.write(rangebits, 4)
        for c in class_list:
            for _ in range(class_dims[c]):
                bw.write(br.read(rangebits), rangebits)

    # residues (2-bit type field instead of 16)
    residue_count = br.read(6) + 1
    bw.write(residue_count - 1, 6)
    for _ in range(residue_count):
        rtype = br.read(2)
        bw.write(rtype, 16)
        bw.write(br.read(24), 24)    # begin
        bw.write(br.read(24), 24)    # end
        bw.write(br.read(24), 24)    # partition_size - 1
        classifications = br.read(6) + 1
        bw.write(classifications - 1, 6)
        classbook = br.read(8)
        bw.write(classbook, 8)
        if classbook >= codebook_count:
            raise WemParseError("residue classbook out of range")
        cascade = []
        for _ in range(classifications):
            low = br.read(3)
            bw.write(low, 3)
            flag = br.read(1)
            bw.write(flag, 1)
            high = 0
            if flag:
                high = br.read(5)
                bw.write(high, 5)
            cascade.append(high * 8 + low)
        for c in cascade:
            for bit in range(8):
                if c & (1 << bit):
                    book = br.read(8)
                    bw.write(book, 8)
                    if book >= codebook_count:
                        raise WemParseError("residue book out of range")

    # mappings (16-bit type 0 field stripped)
    mapping_count = br.read(6) + 1
    bw.write(mapping_count - 1, 6)
    for _ in range(mapping_count):
        bw.write(0, 16)              # mapping_type
        submaps_flag = br.read(1)
        bw.write(submaps_flag, 1)
        submaps = 1
        if submaps_flag:
            submaps = br.read(4) + 1
            bw.write(submaps - 1, 4)
        square_polar = br.read(1)
        bw.write(square_polar, 1)
        if square_polar:
            steps = br.read(8) + 1
            bw.write(steps - 1, 8)
            cbits = ilog(info.channels - 1)
            for _ in range(steps):
                bw.write(br.read(cbits), cbits)  # magnitude
                bw.write(br.read(cbits), cbits)  # angle
        if br.read(2) != 0:
            raise WemParseError("nonzero mapping reserved field")
        bw.write(0, 2)
        if submaps > 1:
            for _ in range(info.channels):
                bw.write(br.read(4), 4)
        for _ in range(submaps):
            bw.write(br.read(8), 8)  # unused time config
            bw.write(br.read(8), 8)  # floor number
            bw.write(br.read(8), 8)  # residue number

    # modes
    mode_count = br.read(6) + 1
    bw.write(mode_count - 1, 6)
    blockflags = []
    for _ in range(mode_count):
        flag = br.read(1)
        bw.write(flag, 1)
        blockflags.append(bool(flag))
        bw.write(0, 16)              # window type
        bw.write(0, 16)              # transform type
        bw.write(br.read(8), 8)      # mapping number
    bw.write(1, 1)                   # framing

    if br.remaining() >= 8:
        raise WemParseError(f"{br.remaining()} unparsed setup bits")
    return bw.to_bytes(), blockflags


def reframe_audio_packet(payload: bytes, next_payload: Optional[bytes],
                         blockflags: List[bool], mode_bits: int,
                         prev_blockflag: bool) -> Tuple[bytes, bool]:
    """Rebuild one mod-packets audio packet: restore the packet-type bit and,
    for long blocks, the prev/next window flags (derived from the neighbor
    packets' modes, exactly as the encoder set them)."""
    br = BitReader(payload)
    bw = BitWriter()
    bw.write(0, 1)                   # packet type: audio
    mode = br.read(mode_bits)
    bw.write(mode, mode_bits)
    if blockflags[mode]:
        next_flag = False
        if next_payload:
            nmode = BitReader(next_payload).read(mode_bits)
            next_flag = blockflags[nmode]
        bw.write(int(prev_blockflag), 1)
        bw.write(int(next_flag), 1)
    copy_bits(br, bw, br.remaining())
    return bw.to_bytes(), blockflags[mode]


# --------------------------------------------------------------------------
# Ogg container
# --------------------------------------------------------------------------

_CRC_TABLE = []


def _ogg_crc_table():
    if not _CRC_TABLE:
        for i in range(256):
            r = i << 24
            for _ in range(8):
                r = ((r << 1) ^ 0x04C11DB7 if r & 0x80000000 else r << 1)
                r &= 0xFFFFFFFF
            _CRC_TABLE.append(r)
    return _CRC_TABLE


def ogg_crc(data: bytes) -> int:
    """Ogg's CRC-32: poly 0x04C11DB7, init 0, not reflected, no final xor."""
    table = _ogg_crc_table()
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ table[((crc >> 24) & 0xFF) ^ b]
    return crc


class OggPageWriter:
    """Packs packets into Ogg pages (lacing, continuation, CRC)."""

    def __init__(self, serial: int = 1):
        self.serial = serial
        self.pageno = 0
        self.out = bytearray()
        self._lacing: List[int] = []
        self._body = bytearray()
        self._granule = -1
        self._continued = False
        self._bos_pending = True

    def _emit(self, granule: int, eos: bool = False) -> None:
        flags = (0x01 if self._continued else 0)
        if self._bos_pending:
            flags |= 0x02
            self._bos_pending = False
        if eos:
            flags |= 0x04
        header = bytearray(b"OggS\x00")
        header.append(flags)
        header += struct.pack("<q", granule)
        header += struct.pack("<I", self.serial)
        header += struct.pack("<I", self.pageno)
        header += b"\x00\x00\x00\x00"
        header.append(len(self._lacing))
        header += bytes(self._lacing)
        page = bytes(header) + bytes(self._body)
        crc = ogg_crc(page)
        page = page[:22] + struct.pack("<I", crc) + page[26:]
        self.out += page
        self.pageno += 1
        self._lacing = []
        self._body = bytearray()
        self._continued = False
        self._granule = -1

    def add_packet(self, payload: bytes, granule: int = -1,
                   eos: bool = False) -> None:
        pos = 0
        n = len(payload)
        while True:
            seg = min(255, n - pos)
            if len(self._lacing) == 255:
                # page full mid-packet → flush with the granule of the last
                # packet that COMPLETED on this page (-1 only when none did,
                # per the Ogg spec), then continue on the next page
                self._emit(self._granule)
                self._continued = True
            self._lacing.append(seg)
            self._body += payload[pos:pos + seg]
            pos += seg
            if seg < 255:
                break
            if pos == n:
                # size is a multiple of 255: a zero lacing value terminates
                if len(self._lacing) == 255:
                    self._emit(self._granule)
                    self._continued = True
                self._lacing.append(0)
                break
        self._granule = granule
        if eos:
            self._emit(granule, eos=True)

    def flush(self, granule: Optional[int] = None) -> None:
        if self._lacing:
            self._emit(self._granule if granule is None else granule)

    def maybe_flush(self, granule: int, body_limit: int = 4096) -> None:
        self._granule = granule
        if len(self._body) >= body_limit or len(self._lacing) >= 250:
            self._emit(granule)

    def to_bytes(self) -> bytes:
        return bytes(self.out)


# --------------------------------------------------------------------------
# Top-level conversion
# --------------------------------------------------------------------------

def wem_to_ogg(src, codebook_path: Optional[str] = None) -> bytes:
    """Convert a Wwise Vorbis ``.wem`` (path or bytes) to an Ogg Vorbis
    stream. Raises :class:`WemParseError` on non-Vorbis or corrupt input."""
    if isinstance(src, (str, os.PathLike)):
        with open(src, "rb") as f:
            data = f.read()
    else:
        data = bytes(src)
    info = parse_wem(data)
    dstart, dsize = info.data_offset, info.data_size
    dend = min(len(data), dstart + dsize)

    if info.header_triad:
        pos = dstart + info.setup_packet_offset
        id_hdr, pos, _ = _read_packet(data, pos, 8)
        comment_hdr, pos, _ = _read_packet(data, pos, 8)
        setup_hdr, pos, _ = _read_packet(data, pos, 8)
        if len(id_hdr) < 30 or id_hdr[0] != 1:
            raise WemParseError("header triad: bad identification header")
        info.blocksize_0_pow = id_hdr[28] & 0x0F
        info.blocksize_1_pow = id_hdr[28] >> 4
        br = BitReader(setup_hdr)
        if br.read(8) != 5 or br.read(48) != int.from_bytes(b"vorbis",
                                                            "little"):
            raise WemParseError("header triad: bad setup header")
        blockflags = _scan_setup_blockflags(setup_hdr, info.channels)
    else:
        setup_payload, _, _ = _read_packet(
            data, dstart + info.setup_packet_offset, info.packet_header)
        library = None
        if info.setup_mode == "external":
            library = CodebookLibrary(codebook_path or DEFAULT_CODEBOOKS)
        setup_hdr, blockflags = rebuild_setup_header(
            setup_payload, info, library)
        id_hdr = build_id_header(info)
        comment_hdr = build_comment_header()

    mode_bits = ilog(len(blockflags) - 1)
    bs = (1 << info.blocksize_0_pow, 1 << info.blocksize_1_pow)

    # collect raw audio packet payloads first (the mod-packet rebuild needs
    # one-packet lookahead for the next-window flag)
    payloads: List[bytes] = []
    pos = dstart + info.first_audio_packet_offset
    while pos < dend:
        payload, pos, _granule = _read_packet(data, pos, info.packet_header)
        if payload:
            payloads.append(payload)

    writer = OggPageWriter()
    writer.add_packet(id_hdr, granule=0)
    writer.flush(0)
    writer.add_packet(comment_hdr)
    writer.add_packet(setup_hdr)
    writer.flush(0)

    total = 0
    prev_block = None  # blocksize of the previous packet (None for first)
    prev_flag = False
    for i, payload in enumerate(payloads):
        if info.mod_packets:
            nxt = payloads[i + 1] if i + 1 < len(payloads) else None
            packet, flag = reframe_audio_packet(
                payload, nxt, blockflags, mode_bits, prev_flag)
            prev_flag = flag
        else:
            packet = payload
            br = BitReader(payload)
            if br.read(1) != 0:
                raise WemParseError("audio packet with non-audio type bit")
            flag = blockflags[br.read(mode_bits)]
        block = bs[1] if flag else bs[0]
        if prev_block is not None:
            total += (prev_block + block) // 4
        prev_block = block
        last = i == len(payloads) - 1
        granule = min(total, info.sample_count) if info.sample_count else total
        writer.add_packet(packet, granule=granule, eos=last)
        if not last:
            writer.maybe_flush(granule)
    if not payloads:
        raise WemParseError("no audio packets")
    return writer.to_bytes()


def _scan_setup_blockflags(setup_hdr: bytes, channels: int) -> List[bool]:
    """Extract mode blockflags from a spec-form setup header (header-triad
    wems) by walking the full structure."""
    br = BitReader(setup_hdr)
    br.read(8 + 48)  # packet type + "vorbis"
    sink = BitWriter()
    codebook_count = br.read(8) + 1
    for _ in range(codebook_count):
        copy_vorbis_codebook(br, sink)
    time_count = br.read(6) + 1
    for _ in range(time_count):
        if br.read(16) != 0:
            raise WemParseError("nonzero time-domain transform")
    floor_count = br.read(6) + 1
    for _ in range(floor_count):
        ftype = br.read(16)
        if ftype == 0:
            br.read(8 + 16 + 16 + 6 + 8)
            nbooks = br.read(4) + 1
            br.read(8 * nbooks)
        elif ftype == 1:
            partitions = br.read(5)
            classes = [br.read(4) for _ in range(partitions)]
            maxc = max(classes) if classes else -1
            dims = []
            for _ in range(maxc + 1):
                dims.append(br.read(3) + 1)
                sub = br.read(2)
                if sub:
                    br.read(8)
                br.read(8 * (1 << sub))
            br.read(2)
            rangebits = br.read(4)
            for c in classes:
                br.read(rangebits * dims[c])
        else:
            raise WemParseError(f"floor type {ftype}")
    residue_count = br.read(6) + 1
    for _ in range(residue_count):
        if br.read(16) > 2:
            raise WemParseError("bad residue type")
        br.read(24 + 24 + 24)
        classifications = br.read(6) + 1
        br.read(8)
        cascade = []
        for _ in range(classifications):
            low = br.read(3)
            high = br.read(5) if br.read(1) else 0
            cascade.append(high * 8 + low)
        for c in cascade:
            br.read(8 * bin(c).count("1"))
    mapping_count = br.read(6) + 1
    for _ in range(mapping_count):
        if br.read(16) != 0:
            raise WemParseError("bad mapping type")
        submaps = (br.read(4) + 1) if br.read(1) else 1
        if br.read(1):
            steps = br.read(8) + 1
            br.read(2 * ilog(channels - 1) * steps)
        if br.read(2) != 0:
            raise WemParseError("nonzero mapping reserved")
        if submaps > 1:
            br.read(4 * channels)
        br.read(24 * submaps)
    mode_count = br.read(6) + 1
    flags = []
    for _ in range(mode_count):
        flags.append(bool(br.read(1)))
        br.read(16 + 16 + 8)
    return flags
