// Fused waveform -> log-mel (+ 513-bin linear) spectrogram for Hopper (sm_90a).
//
// Replaces both Pallas TPU kernels of xva_trainer_tpu/ops/pallas_stft.py:
//   _make_split_kernel (:127, launched at :229, algorithm="split") and
//   _make_kernel       (:100, launched at :256, algorithm="full").
// The two compute one function and differ only in how the TPU's matrix unit
// groups the DFT; this kernel computes that function once. Per frame f of
// item b (n_fft = 1024, any hop):
//   X[k]   = sum_n y[b, f*hop + n] * w[n] * exp(-2 pi i n k / 1024),  k = 0..512
//   mag[k] = sqrt(re^2 + im^2 + mag_eps)            (optional linear output)
//   mel[m] = log(max(sum_k fb[m, k] * mag[k], clip_val))
//
// Bound on an H100 SXM, from what the function needs: for the feature-cache
// bucket (8 items x ~900 frames) the input is read once and both outputs are
// written once, about 24 MB or 7 us at 3.35 TB/s, while a real FFT and the
// nonzero mel weights are about 0.2 GFLOP, 3 us at 67 TFLOP/s of FP32: the
// function is bound by bytes. So the kernel computes the spectrum by an FFT
// (the TPU kernels' DFT product is 70 times the arithmetic), reads each
// sample from device memory once and writes each output once. Measured on
// an H100 80GB HBM3 (PERF.md), writing the linear output takes about as long
// as PyTorch's own fill of that many bytes, and the FFT's passes through
// shared memory most of the rest.
//
// Design:
// - one block = one item x TM frames, one warp a frame (WARPS = TM);
// - the block stages the samples its frames cover, [f0*hop, (f0+TM-1)*hop +
//   1024), once into shared memory with cp.async: 16-byte copies where the
//   address is aligned, 4-byte copies at the ragged ends (a row of odd
//   length starts anywhere), zeros past the end of the row. Every frame is
//   then read from shared memory. For hop > 1024 frames do not overlap and
//   each frame's 1024 samples are staged on their own;
// - one warp per frame: the 1024 windowed real samples are packed as 512
//   complex values z[m] = x[2m] + i x[2m+1] and transformed by a 512-point
//   complex FFT in three radix-8 Stockham passes. Each lane holds two
//   radix-8 butterflies (16 values) in registers; the passes exchange
//   through the frame's shared buffer with __syncwarp only, each exchange
//   in its own layout (one padded, one XOR-swizzled), so that no access has
//   a bank conflict and every address is a lane's base plus a constant;
// - the 513 bins follow from Z: X[k] = E[k] + exp(-2 pi i k / 1024) O[k]
//   with E[k] = (Z[k] + conj Z[-k]) / 2 and O[k] = (Z[k] - conj Z[-k]) / 2i,
//   and the Nyquist bin X[512] = Re Z[0] - Im Z[0] from the same step; Z[-k]
//   sits on a fixed partner lane and comes by warp shuffle;
// - each frame has its own buffer, which ends as the frame's row of 513
//   magnitudes, so the block's magnitudes stay in shared memory for the
//   epilogue at no extra cost: it writes the (B, 513, F) linear output when
//   asked and the (B, 80, F) log-mel, coalesced along frames; the mel
//   projection walks only each filter's nonzero bins;
// - registers and shared memory are kept small enough for two blocks to
//   share an SM (MIN_BLOCKS), so that one block's loads and stores overlap the
//   other's arithmetic.
// The window, the twiddles and the mel filters' nonzero weights are host
// tables, computed in float64 and stored as float32
// (ops/fused_stft.py::kernel_consts), uploaded once per device and staged
// into shared memory with the samples; the twiddles of passes 2 and 3 are
// stored in the order the lanes read them. No fast-math intrinsics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_FFT = 1024;
constexpr int N_HALF = N_FFT / 2;              // length of the complex FFT
constexpr int N_FREQS = N_HALF + 1;
// The tile: frames a block, warps a block, and blocks an SM asked of the
// register allocator (64 registers a thread). The fastest of the tiles that
// scripts/sweep_fused_stft.py times at the feature-cache bucket.
constexpr int TM = 16;
constexpr int WARPS = 16;
constexpr int MIN_BLOCKS = 2;
constexpr int THREADS = 32 * WARPS;
constexpr int SEG = N_FFT + 4;                 // staged floats a frame when hop > 1024
// A frame's buffer: 512 complex values and 32 pad slots, then its
// magnitudes. i * BUF_FLOATS spreads the TM frames of one bin over distinct
// banks.
constexpr int BUF_FLOATS = 2 * (N_HALF + N_HALF / 16) + 32 / TM;
constexpr float SQRT_HALF = 0.70710678118654752f;

static_assert(TM == 8 || TM == 16, "TM must be 8 or 16");
static_assert(TM % WARPS == 0 || WARPS % TM == 0, "TM and WARPS must divide");
static_assert(THREADS % TM == 0, "the epilogue gives each thread one frame");

__host__ __device__ constexpr int span_floats(int hop) {
  return hop > N_FFT ? TM * SEG : (((TM - 1) * hop + N_FFT + 3) + 3) / 4 * 4;
}

constexpr int TABLE_FLOATS = 3 * 2 * N_HALF;  // window pairs, pass twiddles, post twiddles

// mel_floats: the packed mel weights, a multiple of 4; each filter adds one
// int4 (lo, hi, first weight, unused)
__host__ __device__ constexpr size_t smem_bytes(int hop, int n_mels, int mel_floats) {
  return sizeof(float) * (TABLE_FLOATS + 4 * n_mels + mel_floats + span_floats(hop) +
                          TM * BUF_FLOATS);
}

// The two exchanges. A half-warp moves 16 float2 that must fall in 16
// distinct bank pairs (slot mod 16); butterfly j = lane + 32 h, output r.
// Pass 1 writes value 8 j + r and pass 2 reads j + 64 r (16 consecutive j):
// one pad slot after every 16, value i at i + i / 16, which is
// 8 j + j / 2 + r and j + j / 16 + 68 r. Pass 2 writes 64 (j / 8) + j % 8 +
// 8 r and pass 3 reads j + 64 r: bit 3 XOR bit 6, value i at
// i ^ (((i >> 6) & 1) << 3), which is 64 (j / 8) + j % 8 + 8 (r ^ (j / 8 % 2))
// and (j ^ 8 (r % 2)) + 64 r.

__device__ __forceinline__ int misalign(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// Copies row[g0, g0 + len) into dst (16-byte aligned) so that sample g0 + t
// lands at dst[misalign(row + g0) + t]; samples at or past y_len read as 0.
__device__ void stage(float* dst, const float* row, int64_t g0, int len, int64_t y_len) {
  const int mis = misalign(row + g0);
  const int64_t left = y_len - g0;
  const int valid = left <= 0 ? 0 : (left < len ? (int)left : len);
  const int chunks = (mis + len + 3) >> 2;
  for (int c = threadIdx.x; c < chunks; c += THREADS) {
    const int t0 = 4 * c - mis;
    if (t0 >= 0 && t0 + 4 <= valid) {
      cp_async16(dst + 4 * c, row + g0 + t0);
    } else {
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + e;
        if (t < 0 || t >= len) continue;
        if (t < valid) cp_async4(dst + 4 * c + e, row + g0 + t);
        else dst[4 * c + e] = 0.f;
      }
    }
  }
}

__device__ __forceinline__ float2 add(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 sub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// In place: (a0, a1, a2, a3) <- their 4-point DFT.
__device__ __forceinline__ void fft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 t0 = add(a0, a2), t1 = sub(a0, a2), t2 = add(a1, a3), t3 = sub(a1, a3);
  a0 = add(t0, t2);
  a2 = sub(t0, t2);
  a1 = make_float2(t1.x + t3.y, t1.y - t3.x);  // t1 - i t3
  a3 = make_float2(t1.x - t3.y, t1.y + t3.x);  // t1 + i t3
}

// In place: v[r] <- sum_n v[n] exp(-2 pi i n r / 8), as two 4-point DFTs of
// the even and the odd inputs and one radix-2 step.
__device__ __forceinline__ void fft8(float2 (&v)[8]) {
  fft4(v[0], v[2], v[4], v[6]);
  fft4(v[1], v[3], v[5], v[7]);
  const float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
  const float2 o0 = v[1];
  const float2 o1 = make_float2(SQRT_HALF * (v[3].x + v[3].y), SQRT_HALF * (v[3].y - v[3].x));
  const float2 o2 = make_float2(v[5].y, -v[5].x);
  const float2 o3 = make_float2(SQRT_HALF * (v[7].y - v[7].x), -SQRT_HALF * (v[7].x + v[7].y));
  v[0] = add(e0, o0); v[4] = sub(e0, o0);
  v[1] = add(e1, o1); v[5] = sub(e1, o1);
  v[2] = add(e2, o2); v[6] = sub(e2, o2);
  v[3] = add(e3, o3); v[7] = sub(e3, o3);
}

// Pass 1's inputs: butterfly j = lane + 32 h takes z[j + 64 r] of the frame
// at x, windowed; with kPairs, x is 8-byte aligned and each z is one load.
template <bool kPairs>
__device__ __forceinline__ void load_frame(float2 (&v)[2][8], const float* x,
                                           const float2* win2, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int m = lane + 32 * h + 64 * r;
      const float2 w = win2[m];
      const float2 s = kPairs ? reinterpret_cast<const float2*>(x)[m]
                              : make_float2(x[2 * m], x[2 * m + 1]);
      v[h][r] = make_float2(s.x * w.x, s.y * w.y);
    }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fused_stft_kernel(const float* __restrict__ y, int64_t y_stride, int64_t y_len,
                  const float2* __restrict__ win2,    // (512): (w[2m], w[2m+1])
                  const float2* __restrict__ twp,     // (512): pass 2 and 3 twiddles
                  const float2* __restrict__ tw1024,  // (512): exp(-2 pi i k / 1024)
                  const float* __restrict__ melw,     // (mel_floats): nonzero weights
                  const int4* __restrict__ mel_span,  // (n_mels): lo, hi, first weight
                  float* __restrict__ mel_out,        // (B, n_mels, n_frames)
                  float* __restrict__ lin_out,        // (B, N_FREQS, n_frames) or null
                  int n_frames, int hop, int n_mels, int mel_floats, float mag_eps,
                  float clip_val) {
  extern __shared__ __align__(16) float smem[];
  float2* tab = reinterpret_cast<float2*>(smem);  // win2, twp, tw1024
  int4* s_mspan = reinterpret_cast<int4*>(smem + TABLE_FLOATS);
  float* s_melw = smem + TABLE_FLOATS + 4 * n_mels;
  float* span = s_melw + mel_floats;
  float* mag = span + span_floats(hop);  // [TM][BUF_FLOATS]: FFT buffer, then magnitudes

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * TM;
  const int nf = min(TM, n_frames - f0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* row = y + (int64_t)b * y_stride;
  const bool apart = hop > N_FFT;

  // 1. stage the tables and the block's samples
  for (int q = threadIdx.x; q < TABLE_FLOATS / 4; q += THREADS) {
    const float2* src = (q < N_HALF / 2 ? win2 : q < N_HALF ? twp : tw1024) + 2 * (q % (N_HALF / 2));
    cp_async16(reinterpret_cast<float*>(tab + 2 * q), reinterpret_cast<const float*>(src));
  }
  for (int q = threadIdx.x; q < n_mels + mel_floats / 4; q += THREADS) {
    if (q < n_mels) cp_async16(reinterpret_cast<float*>(s_mspan + q),
                               reinterpret_cast<const float*>(mel_span + q));
    else cp_async16(s_melw + 4 * (q - n_mels), melw + 4 * (q - n_mels));
  }
  const float2* s_win = tab;
  const float2* s_twp = tab + N_HALF;
  const float2* s_tw1024 = tab + 2 * N_HALF;
  if (apart) {
    for (int i = 0; i < nf; ++i)
      stage(span + i * SEG, row, (int64_t)(f0 + i) * hop, N_FFT, y_len);
  } else {
    stage(span, row, (int64_t)f0 * hop, (nf - 1) * hop + N_FFT, y_len);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. one warp per frame: 512-point complex FFT, then the 513 magnitudes
  for (int i = warp; i < nf; i += WARPS) {
    float2* buf = reinterpret_cast<float2*>(mag + i * BUF_FLOATS);
    const float* x = apart ? span + i * SEG + misalign(row + (int64_t)(f0 + i) * hop)
                           : span + misalign(row + (int64_t)f0 * hop) + i * hop;
    float2 v[2][8];
    // pass 1 (Ns = 1): butterfly j takes z[j + 64 r], writes 8 j + r
    if ((x - span) & 1) load_frame<false>(v, x, s_win, lane);
    else load_frame<true>(v, x, s_win, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      fft8(v[h]);
      float2* w = buf + 8 * j + (j >> 1);
#pragma unroll
      for (int r = 0; r < 8; ++r) w[r] = v[h][r];
    }
    __syncwarp();
    // pass 2 (Ns = 8): twiddle exp(-2 pi i r (j % 8) / 64), write 64 (j / 8) + j % 8 + 8 r
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      const float2* rd = buf + j + (j >> 4);
#pragma unroll
      for (int r = 0; r < 8; ++r) v[h][r] = rd[68 * r];
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
#pragma unroll
      for (int r = 1; r < 8; ++r) v[h][r] = cmul(v[h][r], s_twp[8 * (r - 1) + (j & 7)]);
      fft8(v[h]);
      const int flip = 8 * ((j >> 3) & 1);
      float2* w = buf + 64 * (j >> 3) + (j & 7);
#pragma unroll
      for (int r = 0; r < 8; ++r) w[(r & 1 ? -flip : flip) + 8 * r] = v[h][r];
    }
    __syncwarp();
    // pass 3 (Ns = 64): twiddle exp(-2 pi i r j / 512); Z[j + 64 r] ends in v[h][r]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      const float2* rd_even = buf + j;
      const float2* rd_odd = buf + (j ^ 8);
#pragma unroll
      for (int r = 0; r < 8; ++r) v[h][r] = (r & 1 ? rd_odd : rd_even)[64 * r];
#pragma unroll
      for (int r = 1; r < 8; ++r) v[h][r] = cmul(v[h][r], s_twp[56 + 64 * (r - 1) + j]);
      fft8(v[h]);
    }
    __syncwarp();  // every lane has read the buffer: the magnitudes may overwrite it
    // post-processing: bins k = j + 64 r, and the Nyquist bin from Z[0]. Z[-k]
    // is on lane (32 - lane) % 32 in v[1 - h][7 - r]; lane 0 is its own
    // partner, with Z[-k] in v[0][-r % 8] (h = 0) or v[1][7 - r] (h = 1).
    float* mrow = mag + i * BUF_FLOATS;
    const int partner = (32 - lane) & 31;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int k = j + 64 * r;
        const float2 a = v[h][r];
        const float2 give = lane == 0 ? v[h][h == 0 ? (8 - r) & 7 : 7 - r] : v[1 - h][7 - r];
        const float2 c = make_float2(__shfl_sync(0xffffffffu, give.x, partner),
                                     __shfl_sync(0xffffffffu, give.y, partner));
        const float er = 0.5f * (a.x + c.x), ei = 0.5f * (a.y - c.y);
        const float orr = 0.5f * (a.y + c.y), oi = -0.5f * (a.x - c.x);
        const float2 t = s_tw1024[k];
        const float re = er + t.x * orr - t.y * oi;
        const float im = ei + t.x * oi + t.y * orr;
        mrow[k] = sqrtf(re * re + im * im + mag_eps);
      }
    }
    const float nyq = v[0][0].x - v[0][0].y;
    if (lane == 0) mrow[N_HALF] = sqrtf(nyq * nyq + mag_eps);
  }
  __syncthreads();

  // 3. epilogue, coalesced along frames: thread = (frame i, every
  //    THREADS / TM-th bin or filter)
  const int i = threadIdx.x % TM;
  if (i >= nf) return;
  const float* mr = mag + i * BUF_FLOATS;
  constexpr int STEP = THREADS / TM;
  if (lin_out != nullptr) {
    float* dst = lin_out + ((int64_t)b * N_FREQS + threadIdx.x / TM) * n_frames + f0 + i;
    for (int k = threadIdx.x / TM; k < N_FREQS; k += STEP, dst += (int64_t)STEP * n_frames)
      *dst = mr[k];
  }
  float* dst = mel_out + ((int64_t)b * n_mels + threadIdx.x / TM) * n_frames + f0 + i;
  for (int m = threadIdx.x / TM; m < n_mels; m += STEP, dst += (int64_t)STEP * n_frames) {
    const int4 f = s_mspan[m];
    const int lo = f.x, hi = f.y;
    const float* w = s_melw + f.z - lo;  // w[k]: the weight of bin k
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;  // four chains, so the loads overlap
    int k = lo;
    for (; k + 4 <= hi; k += 4) {
      a0 = fmaf(w[k], mr[k], a0);
      a1 = fmaf(w[k + 1], mr[k + 1], a1);
      a2 = fmaf(w[k + 2], mr[k + 2], a2);
      a3 = fmaf(w[k + 3], mr[k + 3], a3);
    }
    for (; k < hi; ++k) a0 = fmaf(w[k], mr[k], a0);
    *dst = logf(fmaxf((a0 + a1) + (a2 + a3), clip_val));
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success, and for an empty batch).
int fused_stft_forward(const float* y, int64_t batch, int64_t y_stride, int64_t y_len,
                       const float* win2, const float* twp, const float* tw1024,
                       const float* melw, const int* mel_span, float* mel_out,
                       float* lin_out, int n_frames, int hop, int n_mels, int mel_floats,
                       float mag_eps, float clip_val, void* stream) {
  if (batch <= 0 || n_frames <= 0) return 0;
  if (batch > 65535 || hop <= 0 || mel_floats % 4) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(hop, n_mels, mel_floats);
  cudaError_t err = cudaFuncSetAttribute(
      fused_stft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n_frames + TM - 1) / TM), (unsigned)batch);
  fused_stft_kernel<<<grid, THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      y, y_stride, y_len, reinterpret_cast<const float2*>(win2),
      reinterpret_cast<const float2*>(twp), reinterpret_cast<const float2*>(tw1024), melw,
      reinterpret_cast<const int4*>(mel_span), mel_out, lin_out, n_frames, hop, n_mels,
      mel_floats, mag_eps, clip_val);
  return (int)cudaGetLastError();
}

const char* fused_stft_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
