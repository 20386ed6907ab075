// FLAC decoder of the port's host library, built with the host compiler at
// first use (xva_trainer_tpu_torch/native/__init__.py) and called through
// ctypes; the call holds no Python object, so ctypes releases the GIL and a
// thread pool decodes in parallel.
//
// A copy of the FLAC half of xva_trainer_tpu/native/xva_host.cpp: the same
// bit reader, subframe and frame decode, and the same mono mixdown, so it
// gives the JAX package's samples bit for bit.
//
//   xva_decode_flac — FLAC stream → mono float32 (channel mean), malloc'd
//   xva_free        — frees a buffer this library returned
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

void xva_free(float* p) { free(p); }

// ---------------------------------------------------------------- flac decode
// Native FLAC decoder (the reference leans on a bundled ffmpeg for non-wav
// input — python/audio_format/model.py:5-20; this removes that binary gate
// for FLAC, the only losslessly-specified container in common dataset use).
// Supports: CONSTANT / VERBATIM / FIXED(0-4) / LPC subframes, rice and
// rice2 residual coding with escape partitions, wasted bits, and all four
// stereo decorrelation modes. Output is mono float32 (channel mean).

namespace flacdec {

struct BitReader {
    const uint8_t* p;
    size_t n, pos_byte = 0;
    int pos_bit = 0;  // 0..7, MSB-first
    bool fail = false;
    BitReader(const uint8_t* data, size_t len) : p(data), n(len) {}
    uint32_t bit() {
        if (pos_byte >= n) { fail = true; return 0; }
        uint32_t b = (p[pos_byte] >> (7 - pos_bit)) & 1u;
        if (++pos_bit == 8) { pos_bit = 0; pos_byte++; }
        return b;
    }
    uint64_t bits(int k) {  // k <= 64
        uint64_t v = 0;
        for (int i = 0; i < k; i++) v = (v << 1) | bit();
        return v;
    }
    int64_t sbits(int k) {  // signed two's complement
        uint64_t v = bits(k);
        if (k > 0 && (v >> (k - 1)) & 1u) v |= ~((k == 64) ? 0ull : ((1ull << k) - 1));
        return (int64_t)v;
    }
    uint32_t unary() {
        uint32_t q = 0;
        while (!fail && bit() == 0) q++;
        return q;
    }
    void align() { if (pos_bit) { pos_bit = 0; pos_byte++; } }
};

static int64_t rice_read(BitReader& br, int param) {
    uint32_t q = br.unary();
    uint64_t r = br.bits(param);
    uint64_t v = ((uint64_t)q << param) | r;
    return (v >> 1) ^ -(int64_t)(v & 1);  // zigzag
}

// residual for one subframe (order warmup samples already in out[0..order))
static bool read_residual(BitReader& br, int block_size, int order,
                          int64_t* out) {
    int method = (int)br.bits(2);
    if (method > 1) return false;
    int pbits = method == 0 ? 4 : 5;
    int escape = method == 0 ? 15 : 31;
    int porder = (int)br.bits(4);
    int parts = 1 << porder;
    if (block_size % parts) return false;
    int idx = order;
    for (int pi = 0; pi < parts; pi++) {
        int count = block_size >> porder;
        if (pi == 0) count -= order;
        int param = (int)br.bits(pbits);
        if (param == escape) {
            int raw = (int)br.bits(5);
            for (int i = 0; i < count; i++) out[idx++] = br.sbits(raw);
        } else {
            for (int i = 0; i < count; i++) out[idx++] = rice_read(br, param);
        }
        if (br.fail) return false;
    }
    return idx == block_size;
}

static const int FIXED_ORDERS[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

static bool decode_subframe(BitReader& br, int block_size, int bps,
                            std::vector<int64_t>& out) {
    out.assign(block_size, 0);
    if (br.bit() != 0) return false;  // padding bit
    int type = (int)br.bits(6);
    int wasted = 0;
    if (br.bit()) wasted = 1 + (int)br.unary();
    int eff_bps = bps - wasted;
    if (eff_bps <= 0 || eff_bps > 33) return false;
    if (type == 0) {  // CONSTANT
        int64_t v = br.sbits(eff_bps);
        for (int i = 0; i < block_size; i++) out[i] = v;
    } else if (type == 1) {  // VERBATIM
        for (int i = 0; i < block_size; i++) out[i] = br.sbits(eff_bps);
    } else if (type >= 8 && type <= 12) {  // FIXED order 0-4
        int order = type - 8;
        if (order > block_size) return false;
        for (int i = 0; i < order; i++) out[i] = br.sbits(eff_bps);
        if (!read_residual(br, block_size, order, out.data())) return false;
        for (int i = order; i < block_size; i++) {
            int64_t pred = 0;
            for (int j = 0; j < order; j++)
                pred += (int64_t)FIXED_ORDERS[order][j] * out[i - 1 - j];
            out[i] += pred;
        }
    } else if (type >= 32) {  // LPC, order = type - 31
        int order = type - 31;
        if (order > block_size) return false;
        for (int i = 0; i < order; i++) out[i] = br.sbits(eff_bps);
        int precision = (int)br.bits(4) + 1;
        if (precision == 16) return false;  // 1111 is invalid
        int shift = (int)br.sbits(5);
        if (shift < 0) shift = 0;
        std::vector<int64_t> coef(order);
        for (int i = 0; i < order; i++) coef[i] = br.sbits(precision);
        if (!read_residual(br, block_size, order, out.data())) return false;
        for (int i = order; i < block_size; i++) {
            int64_t pred = 0;
            for (int j = 0; j < order; j++) pred += coef[j] * out[i - 1 - j];
            out[i] += pred >> shift;
        }
    } else {
        return false;  // reserved type
    }
    if (wasted)
        for (int i = 0; i < block_size; i++) out[i] <<= wasted;
    return !br.fail;
}

static int64_t read_utf8(BitReader& br) {
    uint32_t b0 = (uint32_t)br.bits(8);
    int extra = 0;
    uint64_t v;
    if ((b0 & 0x80) == 0) return b0;
    else if ((b0 & 0xE0) == 0xC0) { v = b0 & 0x1F; extra = 1; }
    else if ((b0 & 0xF0) == 0xE0) { v = b0 & 0x0F; extra = 2; }
    else if ((b0 & 0xF8) == 0xF0) { v = b0 & 0x07; extra = 3; }
    else if ((b0 & 0xFC) == 0xF8) { v = b0 & 0x03; extra = 4; }
    else if ((b0 & 0xFE) == 0xFC) { v = b0 & 0x01; extra = 5; }
    else if (b0 == 0xFE) { v = 0; extra = 6; }
    else return -1;
    for (int i = 0; i < extra; i++) {
        uint32_t b = (uint32_t)br.bits(8);
        if ((b & 0xC0) != 0x80) return -1;
        v = (v << 6) | (b & 0x3F);
    }
    return (int64_t)v;
}

static const int BLOCK_SIZES[16] = {0, 192, 576, 1152, 2304, 4608, -1, -2,
                                    256, 512, 1024, 2048, 4096, 8192, 16384,
                                    32768};
static const int SAMPLE_RATES[16] = {0, 88200, 176400, 192000, 8000, 16000,
                                     22050, 24000, 32000, 44100, 48000, 96000,
                                     -1, -2, -3, 0};

}  // namespace flacdec

static int xva_decode_flac_impl(const char* path, float** out, int* n_samples,
                                int* sample_rate) {
    using namespace flacdec;
    FILE* f = fopen(path, "rb");
    if (!f) return 1;
    fseek(f, 0, SEEK_END);
    long fsize = ftell(f);
    fseek(f, 0, SEEK_SET);
    if (fsize < 42) { fclose(f); return 2; }
    std::vector<uint8_t> buf((size_t)fsize);
    if (fread(buf.data(), 1, (size_t)fsize, f) != (size_t)fsize) {
        fclose(f);
        return 2;
    }
    fclose(f);
    if (memcmp(buf.data(), "fLaC", 4) != 0) return 3;

    // metadata blocks; STREAMINFO is mandatory first
    size_t pos = 4;
    int sr = 0, channels = 0, bps = 0;
    uint64_t total = 0;
    bool last = false, first = true;
    while (!last) {
        if (pos + 4 > buf.size()) return 4;
        last = (buf[pos] & 0x80) != 0;
        int btype = buf[pos] & 0x7F;
        uint32_t blen = ((uint32_t)buf[pos + 1] << 16) |
                        ((uint32_t)buf[pos + 2] << 8) | buf[pos + 3];
        pos += 4;
        if (pos + blen > buf.size()) return 4;
        if (first) {
            if (btype != 0 || blen < 34) return 4;  // STREAMINFO
            const uint8_t* s = &buf[pos];
            sr = ((int)s[10] << 12) | ((int)s[11] << 4) | (s[12] >> 4);
            channels = ((s[12] >> 1) & 0x7) + 1;
            bps = (((s[12] & 1) << 4) | (s[13] >> 4)) + 1;
            total = ((uint64_t)(s[13] & 0x0F) << 32) | ((uint64_t)s[14] << 24) |
                    ((uint64_t)s[15] << 16) | ((uint64_t)s[16] << 8) | s[17];
            first = false;
        }
        pos += blen;
    }
    if (sr <= 0 || channels < 1 || channels > 8 || bps < 4 || bps > 32)
        return 4;

    std::vector<float> mono;
    // clamp the (untrusted, 36-bit) STREAMINFO total before reserving:
    // a corrupt field must not request hundreds of GB. Bound by what the
    // file could possibly hold (mono samples can't exceed total bits).
    uint64_t cap = (uint64_t)fsize * 8ull;
    if (total && total <= cap) mono.reserve((size_t)total);
    std::vector<std::vector<int64_t>> ch(channels);
    const double scale = 1.0 / (double)(1ll << (bps - 1));

    while (pos < buf.size()) {
        BitReader br(buf.data() + pos, buf.size() - pos);
        if (br.bits(14) != 0x3FFE) break;  // sync (or trailing garbage)
        br.bit();                          // reserved
        br.bit();                          // blocking strategy
        int bs_code = (int)br.bits(4);
        int sr_code = (int)br.bits(4);
        int ch_code = (int)br.bits(4);
        int ss_code = (int)br.bits(3);
        br.bit();  // reserved
        if (read_utf8(br) < 0) return 5;
        int block_size = BLOCK_SIZES[bs_code];
        if (block_size == -1) block_size = (int)br.bits(8) + 1;
        else if (block_size == -2) block_size = (int)br.bits(16) + 1;
        else if (block_size == 0) return 5;
        if (SAMPLE_RATES[sr_code] == -1) br.bits(8);
        else if (SAMPLE_RATES[sr_code] == -2) br.bits(16);
        else if (SAMPLE_RATES[sr_code] == -3) br.bits(16);
        br.bits(8);  // header CRC-8 (decode is not verification-grade)
        int fbps = bps;
        static const int SS[8] = {0, 8, 12, -1, 16, 20, 24, 32};
        if (ss_code != 0 && SS[ss_code] > 0) fbps = SS[ss_code];

        int nch = channels;
        int mode = 0;  // 0 independent, 1 L/S, 2 R/S, 3 M/S
        if (ch_code >= 8 && ch_code <= 10) { nch = 2; mode = ch_code - 7; }
        else if (ch_code < 8) nch = ch_code + 1;
        else return 5;
        if (nch != channels) return 5;

        for (int c = 0; c < nch; c++) {
            int sub_bps = fbps;
            // side channel carries one extra bit
            if ((mode == 1 && c == 1) || (mode == 2 && c == 0) ||
                (mode == 3 && c == 1))
                sub_bps += 1;
            if (!decode_subframe(br, block_size, sub_bps, ch[c])) return 6;
        }
        br.align();
        br.bits(16);  // frame CRC-16
        if (br.fail) return 6;

        // stereo decorrelation
        if (mode == 1) {  // left/side: right = left - side
            for (int i = 0; i < block_size; i++) ch[1][i] = ch[0][i] - ch[1][i];
        } else if (mode == 2) {  // right/side: left = right + side
            for (int i = 0; i < block_size; i++) ch[0][i] = ch[1][i] + ch[0][i];
        } else if (mode == 3) {  // mid/side
            for (int i = 0; i < block_size; i++) {
                int64_t mid = ch[0][i], side = ch[1][i];
                mid = (mid << 1) | (side & 1);
                ch[0][i] = (mid + side) >> 1;
                ch[1][i] = (mid - side) >> 1;
            }
        }
        for (int i = 0; i < block_size; i++) {
            double acc = 0;
            for (int c = 0; c < channels; c++) acc += (double)ch[c][i];
            mono.push_back((float)(acc * scale / channels));
        }
        pos += br.pos_byte + (br.pos_bit ? 1 : 0);
    }
    if (mono.empty()) return 6;
    // A failed mid-file frame-sync exits the loop silently; when STREAMINFO
    // declares the stream length, a shortfall means corruption — report it
    // so the caller engages its ffmpeg fallback instead of consuming a
    // truncated decode.
    if (total && mono.size() < total) return 6;
    if (total && mono.size() > total) mono.resize((size_t)total);
    float* res = (float*)malloc(sizeof(float) * mono.size());
    if (!res) return 7;
    memcpy(res, mono.data(), sizeof(float) * mono.size());
    *out = res;
    *n_samples = (int)mono.size();
    *sample_rate = sr;
    return 0;
}

int xva_decode_flac(const char* path, float** out, int* n_samples,
                    int* sample_rate) {
    // exceptions (bad_alloc from corrupt sizes, etc.) must not cross the
    // extern "C" boundary — they would std::terminate the whole Python
    // process instead of letting the caller fall back to ffmpeg
    try {
        return xva_decode_flac_impl(path, out, n_samples, sample_rate);
    } catch (...) {
        return 8;
    }
}

}  // extern "C"
