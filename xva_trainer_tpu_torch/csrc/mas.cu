// Monotonic alignment search (MAS) for Hopper (sm_90a).
//
// Replaces the on-device dynamic program of xva_trainer_tpu/ops/mas.py
// (maximum_path, :30-93). That one is two lax.scan loops, not a Pallas
// kernel; in PyTorch the same loops would launch a few ops per mel frame.
// Per batch item b, with value v = value[b] (t_x text positions x t_y mel
// frames) set to -inf where mask[b] is 0, and lengths x_len, y_len:
//   q_0[x]  = v[0, 0] if x == 0 else -inf
//   q_y[x]  = v[x, y] + max(q_{y-1}[x-1], q_{y-1}[x]),  q_{y-1}[-1] = -inf
//   d_y[x]  = q_{y-1}[x-1] >= q_{y-1}[x]                (the diagonal wins ties)
// then a backtrack from (x_len-1, y_len-1) that steps x down by d_y[x] at
// every frame y > 0, and path[x, y] = mask[x, y] on the path, 0 elsewhere.
// An x below 0 (reached only through -inf scores in row 0) reads its bit as
// xva_trainer_tpu/ops/mas.py:81's take_along_axis does: x in [-t_x, -1] at
// x + t_x, x < -t_x as 1 (the gather's fill value for booleans).
// The sums are fp32 for fp32 and bf16 input alike, taken in the same order as
// the JAX scan and the plain version (ops/mas.py), so the path is identical,
// not close. The path is written in the value's type.
//
// Bound on an H100 SXM at the trainer's largest bucket (B = 64, 192 x 768,
// ragged lengths): the function needs value and mask only in [0, x_len) x
// [0, y_len) (no score at x >= x_len reaches the backtrack, which starts at
// x_len - 1 and only steps down; frames >= y_len emit nothing) and writes the
// whole path once: 67-75 MB, 0.020-0.022 ms at 3.35 TB/s. The chain of y_len
// dependent frames (an add and a max each) is about 0.003 ms. So bytes bind
// the card; but with one block an item, each SM streams its own item while
// one warp runs that item's chain, and the longest item sets the time. The
// design, against what the first version lost (PERF.md, section 6):
// - Staged tiles, no global load on the chain. Seven producer warps copy
//   tiles of F frames (32; 16 or 8 where shared memory is short) of value
//   and mask, rows [0, x_len) only, into a ring of 3 (or 2) stages with
//   cp.async: 16 bytes a copy (8 for bf16) where the rows are aligned, else
//   4. Once a tile has landed they set its values to -inf where the mask is
//   not > 0, in place, so the DP reads one array. The DP warp waits on the
//   ring once a tile.
// - A register DP in one warp. Lane l holds the K rows x = Kl + k (K odd:
//   1, 3, 5, 7 or 9, so one warp covers t_x <= 288: every v3 bucket and
//   FastPitch's 256). Staged rows are F + 4 elements, an odd number of
//   16-byte (fp32) or 8-byte (bf16) units, so a lane's load of four frames
//   of its row, K rows from its neighbour's, is conflict-free. A group of four
//   frames is K vector loads; a frame is one __shfl_up_sync (row Kl - 1 from
//   lane l - 1), K compares, maxes and adds, and one word of K direction bits
//   a lane. Above 288 positions, W warps of K = 9 pass their last score on
//   through shared memory with a named barrier a frame. The bits (24 KB at
//   192 x 768) stay in shared memory where they fit, else in a scratch
//   tensor of the wrapper.
// - The backtrack as a short chain. One thread walks (lane, k) with no
//   division; x falls at most one row a frame, so for D = min(4, K) frames
//   every bit it needs is in the words of two lanes, loaded together.
// - The path written once. While the DP runs, the producers zero the item's
//   path with 16-byte stores, a slice a tile; after the backtrack each active
//   frame's one on-path entry is written as mask[x, y], one gather a frame.
// - Once the backtrack leaves the item's rows (x < 0, which needs -inf in
//   row 0) it never returns and no later frame emits, so the bits it reads
//   at x + t_x (rows the DP may have skipped) cannot change the path; they
//   are read only so that no address leaves the item's own bits.
// - One block an item fills min(B, 132) SMs: 64 at the largest bucket, where
//   the longest item's chain of 768 frames sets the time. Splitting an item
//   over more SMs would not shorten that chain (see PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int PRODUCER_WARPS = 7;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// torch.maximum / jnp.maximum: NaN if either side is NaN (one instruction)
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Four consecutive frames of one staged row (16 bytes of fp32, 8 of bf16),
// loaded and stored as volatile asm, so that the compiler keeps them where
// they are written: it once predicated a value's load on its mask's.
__device__ __forceinline__ void lds4(unsigned addr, float (&o)[4], float) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(o[0]), "=f"(o[1]), "=f"(o[2]), "=f"(o[3])
               : "r"(addr));
}
__device__ __forceinline__ void lds4(unsigned addr, float (&o)[4], __nv_bfloat16) {
  unsigned w0, w1;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];" : "=r"(w0), "=r"(w1) : "r"(addr));
  o[0] = __uint_as_float(w0 << 16);  // a bf16 is the top half of its fp32
  o[1] = __uint_as_float(w0 & 0xffff0000u);
  o[2] = __uint_as_float(w1 << 16);
  o[3] = __uint_as_float(w1 & 0xffff0000u);
}
__device__ __forceinline__ void sts4(unsigned addr, const float (&o)[4], float) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "f"(o[0]), "f"(o[1]),
               "f"(o[2]), "f"(o[3])
               : "memory");
}
__device__ __forceinline__ void sts4(unsigned addr, const float (&o)[4], __nv_bfloat16) {
  // the values are bf16 or -inf, so their top halves are exact
  const unsigned w0 = (__float_as_uint(o[0]) >> 16) | (__float_as_uint(o[1]) & 0xffff0000u);
  const unsigned w1 = (__float_as_uint(o[2]) >> 16) | (__float_as_uint(o[3]) & 0xffff0000u);
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};" ::"r"(addr), "r"(w0), "r"(w1) : "memory");
}
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "n"(BYTES)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the DP warps' barrier (id 1) and the producers' (id 2); 0 is __syncthreads
__device__ __forceinline__ void dp_barrier(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}
__device__ __forceinline__ void producer_barrier(int threads) {
  asm volatile("bar.sync 2, %0;\n" ::"r"(threads) : "memory");
}

__host__ __device__ constexpr int align16(int n) { return (n + 15) / 16 * 16; }
// staged row length in elements, F + 4: an odd number of 16-byte units for
// fp32 and of 8-byte units for bf16, so that a quarter (half) warp loading
// four frames of rows K apart (K odd) hits distinct banks
__host__ __device__ constexpr int row_elems(int frames) { return frames + 4; }
// K, the text positions a lane holds: odd, so that with rows of an odd
// number of load units the lanes' loads fall on distinct banks
__host__ __device__ constexpr int chunk_for(int tx) {
  return tx <= 32 ? 1 : tx <= 96 ? 3 : tx <= 160 ? 5 : tx <= 224 ? 7 : 9;
}
// bytes of one lane's direction bits a frame
__host__ __device__ constexpr int bits_bytes(int k) { return k > 8 ? 2 : 1; }

// Bytes a copy for one array: 16 (fp32) or 8 (bf16: its staged rows are
// 8-byte aligned) where the tensor's start and its rows of t_y elements are
// aligned to it, else 4, else 2 (bf16 in rows of odd length: plain copies).
template <typename T>
__device__ __forceinline__ int copy_width(const T* base, int ty) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  const int row = ty * (int)sizeof(T);
  for (int w = sizeof(T) == 4 ? 16 : 8; w >= 4; w /= 2)
    if (row % w == 0 && a % w == 0) return w;
  return (int)sizeof(T);
}

// Copies tile rows [0, rows) x frames [y0, y0 + ncols) of one (t_x, t_y)
// array into a stage of row length S, `width` bytes a copy. Producer thread
// p takes the copy p % cpr of rows p / cpr + n * (np / cpr), cpr being the
// copies a row of F frames (a power of 2 that divides np).
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, int rows, int ty, int y0,
                                           int ncols, int S, int log_f, int width, int p,
                                           int np) {
  const int log_e = __ffs(width / (int)sizeof(T)) - 1;  // elements a copy, as a power of 2
  const int log_cpr = log_f - log_e;
  const int c = (p & ((1 << log_cpr) - 1)) << log_e, step = np >> log_cpr;
  if (c >= ncols) return;
  int x = p >> log_cpr;
  const T* from = src + (size_t)x * ty + y0 + c;
  T* to = dst + x * S + c;
  for (; x < rows; x += step, from += (size_t)step * ty, to += step * S) {
    if (width == 16) cp_async<16>(to, from);
    else if (width == 8) cp_async<8>(to, from);
    else if (width == 4) cp_async<4>(to, from);
    else to[0] = from[0];
  }
}

// Sets a staged tile's values to -inf where its mask is not > 0, in place
// and in the value's type, four frames a step, over rows [0, rows) and
// frames [0, ncols): the DP then reads one array and selects nothing.
template <typename TV, typename TM>
__device__ __forceinline__ void mask_tile(TV* sv, const TM* sm, int rows, int ncols, int S,
                                          int log_f, int p, int np) {
  const int log_g = log_f - 2;  // 4-frame groups a row
  for (int i = p; i < (rows << log_g); i += np) {
    const int x = i >> log_g, c = (i & ((1 << log_g) - 1)) * 4;
    if (c >= ncols) continue;
    float mv[4], vv[4];
    lds4(smem_addr(sm + x * S + c), mv, TM());
    lds4(smem_addr(sv + x * S + c), vv, TV());
#pragma unroll
    for (int j = 0; j < 4; ++j) vv[j] = mv[j] > 0.f ? vv[j] : -INFINITY;
    sts4(smem_addr(sv + x * S + c), vv, TV());
  }
}

// MULTI: W >= 1 warps of K = 9 and the direction bits in shared memory or
// in scratch; otherwise one warp and the bits in shared memory, both known
// to the compiler (shared-memory instructions, no exchange between warps).
template <typename TV, typename TM, int K, bool MULTI>
__global__ void __launch_bounds__(512, 1)
    mas_kernel(const TV* __restrict__ value, const TM* __restrict__ mask,
               const int* __restrict__ x_lens, const int* __restrict__ y_lens,
               TV* __restrict__ path, unsigned char* __restrict__ dirs_scratch, int tx, int ty,
               int log_f, int stages, int n_dp_warps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = 1 << log_f;
  using Bits = typename std::conditional<(K > 8), uint16_t, uint8_t>::type;
  const int W = MULTI ? n_dp_warps : 1, R = 32 * W;  // R: lanes' bit words a frame
  const int s_len = row_elems(F);
  const int v_bytes = align16(tx * s_len * (int)sizeof(TV));
  const int stage_bytes = v_bytes + align16(tx * s_len * (int)sizeof(TM));
  unsigned char* after_ring = smem + stages * stage_bytes;
  unsigned char* dirs = after_ring;
  if (MULTI && dirs_scratch) {
    dirs = dirs_scratch + (size_t)blockIdx.x * ty * R * sizeof(Bits);
  } else {
    after_ring += align16(ty * R * (int)sizeof(Bits));
  }
  int* xs = reinterpret_cast<int*>(after_ring);                              // ty
  float* bnd = reinterpret_cast<float*>(after_ring + align16(4 * ty));       // 2 x W

  const size_t base = (size_t)blockIdx.x * tx * ty;
  const TV* v = value + base;
  const TM* m = mask + base;
  TV* out = path + base;
  const int x_len = x_lens[blockIdx.x];
  const int y_len = y_lens[blockIdx.x];
  const int n_tiles = (y_len + F - 1) / F;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool is_dp = warp < W;
  const int p = threadIdx.x - 32 * W, np = blockDim.x - 32 * W;  // producer index, count

  // The path's zero fill: 16-byte stores over the aligned interior of the
  // item's span, a slice a tile; the unaligned head and tail with the first.
  const uintptr_t span0 = reinterpret_cast<uintptr_t>(out);
  const size_t span_bytes = (size_t)tx * ty * sizeof(TV);
  const size_t head = min((size_t)((16 - (span0 & 15)) & 15), span_bytes);
  const size_t chunks = (span_bytes - head) / 16;
  const size_t per_tile = (chunks + n_tiles - 1) / n_tiles;
  uint4* interior = reinterpret_cast<uint4*>(span0 + head);

  auto stage_v = [&](int s) { return reinterpret_cast<TV*>(smem + s * stage_bytes); };
  auto stage_m = [&](int s) {
    return reinterpret_cast<TM*>(smem + s * stage_bytes + v_bytes);
  };

  const int v_width = copy_width(value, ty), m_width = copy_width(mask, ty);
  auto load = [&](int t) {
    const int y0 = t * F, ncols = min(F, y_len - y0), s = t % stages;
    stage_tile(stage_v(s), v, x_len, ty, y0, ncols, s_len, log_f, v_width, p, np);
    stage_tile(stage_m(s), m, x_len, ty, y0, ncols, s_len, log_f, m_width, p, np);
  };
  // once tile t has landed (every producer waited for its own copies)
  auto mask_landed = [&](int t) {
    producer_barrier(np);
    if (t < n_tiles)
      mask_tile(stage_v(t % stages), stage_m(t % stages), x_len, min(F, y_len - t * F), s_len,
                log_f, p, np);
  };
  if (!is_dp) {
    for (int t = 0; t < stages - 1; ++t) {
      if (t < n_tiles) load(t);
      cp_async_commit();
    }
    if (stages == 3) cp_async_wait<1>(); else cp_async_wait<0>();
    mask_landed(0);
  }
  __syncthreads();

  float q[K];
  const int x0 = K * (32 * warp + lane);  // this lane's rows: [x0, x0 + K)
  Bits* my_dirs = reinterpret_cast<Bits*>(dirs) + warp * 32 + lane;
  for (int t = 0; t < n_tiles; ++t) {
    if (is_dp) {
      // this tile's row addresses; rows >= t_x read row t_x - 1 (their
      // scores only feed rows above them, which no backtrack visits)
      unsigned av[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        av[k] = smem_addr(stage_v(t % stages) + min(x0 + k, tx - 1) * s_len);
      const int y0 = t * F, c_end = min(F, y_len - y0);
      for (int c = 0; c < c_end; c += 4) {  // four frames a group, from K loads
        float vg[K][4];  // v[x, y0 + c + j], -inf where the mask is not > 0
#pragma unroll
        for (int k = 0; k < K; ++k) lds4(av[k] + c * (int)sizeof(TV), vg[k], TV());
        auto frame = [&](int j, int y) {
          const float left = (MULTI && warp > 0) ? bnd[((y - 1) & 1) * W + warp - 1]
                                                   : -INFINITY;
          float up = __shfl_up_sync(FULL, q[K - 1], 1);  // lane l - 1's last row
          if (lane == 0) up = left;
          unsigned bits = 0;
#pragma unroll
          for (int k = K - 1; k >= 0; --k) {  // downwards: q[k - 1] is still the last frame's
            const float shifted = k > 0 ? q[k - 1] : up;
            bits |= (unsigned)(shifted >= q[k]) << k;
            q[k] = vg[k][j] + nan_max(shifted, q[k]);
          }
          my_dirs[(size_t)y * R] = (Bits)bits;
          if (MULTI) {
            if (lane == 31) bnd[(y & 1) * W + warp] = q[K - 1];
            dp_barrier(32 * W);
          }
        };
        if (c + 4 <= c_end && y0 + c > 0) {
#pragma unroll
          for (int j = 0; j < 4; ++j) frame(j, y0 + c + j);
        } else {  // frame 0, or the tile's last frames
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int y = y0 + c + j;
            if (c + j >= c_end) break;
            if (y > 0) {
              frame(j, y);
            } else {  // frame 0: only x = 0 is reachable
#pragma unroll
              for (int k = 0; k < K; ++k) q[k] = -INFINITY;
              if (x0 == 0) q[0] = vg[0][0];
              if (MULTI) {
                if (lane == 31) bnd[warp] = q[K - 1];
                dp_barrier(32 * W);
              }
            }
          }
        }
      }
    } else {
      if (t + stages - 1 < n_tiles) load(t + stages - 1);
      cp_async_commit();
      if (t == 0) {
        for (size_t i = p; i < head / sizeof(TV); i += np) out[i] = from_float<TV>(0.f);
        const size_t tail0 = (head + chunks * 16) / sizeof(TV);
        for (size_t i = tail0 + p; i < (size_t)tx * ty; i += np) out[i] = from_float<TV>(0.f);
      }
      const size_t end = min(chunks, (t + 1) * per_tile);
      for (size_t i = t * per_tile + p; i < end; i += np) interior[i] = make_uint4(0, 0, 0, 0);
      if (stages == 3) cp_async_wait<1>(); else cp_async_wait<0>();
      mask_landed(t + 1);
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {  // the backtrack
    // x = K * slot + k: the bits of x are bit k of lane slot's word
    const Bits* d = reinterpret_cast<const Bits*>(dirs);
    int y = y_len - 1, slot = (x_len - 1) / K, k = x_len - 1 - slot * K;
    // D frames a step: x falls at most D - 1 <= K - 1 positions in them, so
    // every bit they read is in the words of lanes slot and slot - 1; all 2D
    // loads go out together and each frame is a shift, an and and an add.
    constexpr int D = K >= 4 ? 4 : K;
    if (K >= 3) {
      for (; y >= D && slot >= 1; y -= D) {
        unsigned u[D];  // bit K + j of u is row slot's bit j, bit j row slot - 1's
#pragma unroll
        for (int j = 0; j < D; ++j) {
          const Bits* row = d + (size_t)(y - j) * R;
          u[j] = ((unsigned)row[slot] << K) | row[slot - 1];
        }
        int drop = 0;
#pragma unroll
        for (int j = 0; j < D; ++j) {
          xs[y - j] = K * slot + k - drop;
          drop += (u[j] >> (K + k - drop)) & 1;
        }
        k -= drop;
        if (k < 0) k += K, --slot;
      }
    }
    for (; y > 0 && slot >= 0; --y) {  // a shared load and a shift a frame
      xs[y] = K * slot + k;
      k -= (d[(size_t)y * R + slot] >> k) & 1;
      if (k < 0) k = K - 1, --slot;
    }
    for (int x = K * slot + k; y >= 0; --y) {  // below x = 0: no frame emits, x never returns
      xs[y] = x;
      if (y > 0) {
        int bit = 1;  // x < -t_x: the gather's fill
        if (x >= -tx) {
          const int xi = x + tx;
          bit = (d[(size_t)y * R + xi / K] >> (xi % K)) & 1;
        }
        x -= bit;
      }
    }
  }
  __syncthreads();

  for (int y = threadIdx.x; y < y_len; y += blockDim.x) {
    const int x = xs[y];
    if (x >= 0) {
      const size_t i = (size_t)x * ty + y;
      out[i] = from_float<TV>(to_float(m[i]));
    }
  }
}

// Shared memory of one block; the wrapper's shared_bytes() computes the same.
int shared_bytes(int tx, int ty, int vb, int mb, int frames, int stages, bool dirs_shared) {
  const int K = chunk_for(tx), W = (tx + 32 * K - 1) / (32 * K);
  const int stage = align16(tx * row_elems(frames) * vb) + align16(tx * row_elems(frames) * mb);
  return stages * stage + (dirs_shared ? align16(ty * 32 * W * bits_bytes(K)) : 0) +
         align16(4 * ty) + align16(8 * W);
}

template <typename TV, typename TM, int K, bool MULTI>
int launch_k(const void* value, const void* mask, const int* x_lens, const int* y_lens,
             void* path, void* scratch, int batch, int tx, int ty, int log_f, int stages,
             int dp_warps, int smem, cudaStream_t stream) {
  auto kernel = mas_kernel<TV, TM, K, MULTI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, 32 * (dp_warps + PRODUCER_WARPS), smem, stream>>>(
      reinterpret_cast<const TV*>(value), reinterpret_cast<const TM*>(mask), x_lens, y_lens,
      reinterpret_cast<TV*>(path), reinterpret_cast<unsigned char*>(scratch), tx, ty, log_f,
      stages, dp_warps);
  return (int)cudaGetLastError();
}

template <typename TV, typename TM>
int launch(const void* value, const void* mask, const int* x_lens, const int* y_lens,
           void* path, void* scratch, int batch, int tx, int ty, int log_f, int stages,
           int smem, cudaStream_t stream) {
  const int K = chunk_for(tx);
  const int W = (tx + 32 * K - 1) / (32 * K);
  if (W > 1 || scratch)  // K = 9 covers any t_x <= 288 in one warp too
    return launch_k<TV, TM, 9, true>(value, mask, x_lens, y_lens, path, scratch, batch, tx, ty,
                                     log_f, stages, W, smem, stream);
#define MAS_K(k)                                                                          \
  case k:                                                                                 \
    return launch_k<TV, TM, k, false>(value, mask, x_lens, y_lens, path, scratch, batch, tx, \
                                      ty, log_f, stages, 1, smem, stream);
  switch (K) {
    MAS_K(1)
    MAS_K(3)
    MAS_K(5)
    MAS_K(7)
    MAS_K(9)
  }
#undef MAS_K
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// value and path: (batch, tx, ty) of value_type; mask: (batch, tx, ty) of
// mask_type (0 = float32, 1 = bfloat16); x_lens, y_lens: (batch,) int32 in
// [1, tx] and [1, ty]. frames (8, 16 or 32) and stages (2 or 3) set the ring
// of staged tiles; scratch is null when the direction bits stay in shared
// memory, else (batch, ty, 32 * ceil(tx / 288), 2) bytes. smem_bytes
// must equal the layout's size (the wrapper's shared_bytes). Launches on
// `stream`, allocates nothing; returns cudaGetLastError() after the launch
// (0 on success, and for an empty batch).
int mas_forward(const void* value, const void* mask, const int* x_lens, const int* y_lens,
                void* path, void* scratch, int batch, int tx, int ty, int value_type,
                int mask_type, int frames, int stages, int smem_bytes, void* stream) {
  if (batch <= 0) return 0;
  const int log_f = frames == 8 ? 3 : frames == 16 ? 4 : frames == 32 ? 5 : -1;
  if (tx <= 0 || ty <= 0 || value_type < 0 || value_type > 1 || mask_type < 0 ||
      mask_type > 1 || log_f < 0 || stages < 2 || stages > 3 ||
      smem_bytes != shared_bytes(tx, ty, value_type ? 2 : 4, mask_type ? 2 : 4, frames,
                                 stages, scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (value_type == 0) {
    return mask_type == 0
               ? launch<float, float>(value, mask, x_lens, y_lens, path, scratch, batch, tx,
                                      ty, log_f, stages, smem_bytes, s)
               : launch<float, __nv_bfloat16>(value, mask, x_lens, y_lens, path, scratch,
                                              batch, tx, ty, log_f, stages, smem_bytes, s);
  }
  return mask_type == 0
             ? launch<__nv_bfloat16, float>(value, mask, x_lens, y_lens, path, scratch, batch,
                                            tx, ty, log_f, stages, smem_bytes, s)
             : launch<__nv_bfloat16, __nv_bfloat16>(value, mask, x_lens, y_lens, path,
                                                    scratch, batch, tx, ty, log_f, stages,
                                                    smem_bytes, s);
}

const char* mas_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
