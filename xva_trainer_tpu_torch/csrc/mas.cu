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
// The sums are fp32 for fp32 and bf16 input alike, taken in the same order as
// the JAX scan and the plain version (ops/mas.py), so the path is identical,
// not close. The path is written in the value's type.
//
// Bound on an H100 SXM at the trainer's largest bucket (B = 64, 192 x 768):
// the value and the mask are read once and the path written once, 113 MB,
// 34 us at 3.35 TB/s; the dynamic program is a chain of t_y dependent steps
// (an add and a max each), about 3 us at 1.98 GHz. So the bytes bind. This
// first version is simple and right, not fast:
// - one block per batch item, one thread per text position (a loop when
//   t_x > 1024);
// - the running scores q live in shared memory, ping-ponged between two rows,
//   one __syncthreads per frame, and only frames y < y_len are computed;
// - the direction bits are packed 32 to a word by __ballot_sync and kept in
//   shared memory, (t_y x ceil(t_x/32)) words: 18 KB at 192 x 768;
// - one thread backtracks through them and records the path's x for each
//   frame; then all threads write the whole path row by row, coalesced
//   along frames.
// Reading v[x, y] for all x at one frame is a strided access (stride t_y);
// each 32-byte sector fetched serves the next frames from L1. Staging tiles
// of frames through shared memory is the first speed-up, left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// torch.maximum / jnp.maximum: NaN if either side is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

template <typename TV, typename TM>
__global__ void mas_kernel(const TV* __restrict__ value, const TM* __restrict__ mask,
                           const int* __restrict__ x_lens, const int* __restrict__ y_lens,
                           TV* __restrict__ path, int tx, int ty, int words) {
  extern __shared__ unsigned char smem[];
  float* q = reinterpret_cast<float*>(smem);                       // 2 rows of tx
  unsigned* dirs = reinterpret_cast<unsigned*>(q + 2 * tx);        // ty rows of words
  int* xs = reinterpret_cast<int*>(dirs + (size_t)ty * words);     // ty

  const size_t base = (size_t)blockIdx.x * tx * ty;
  const TV* v = value + base;
  const TM* m = mask + base;
  TV* out = path + base;
  const int x_len = x_lens[blockIdx.x];
  const int y_len = y_lens[blockIdx.x];
  const int lane = threadIdx.x & 31;
  const float neg_inf = -INFINITY;

  for (int x = threadIdx.x; x < tx; x += blockDim.x) {
    const size_t i = (size_t)x * ty;
    q[x] = (x == 0 && to_float(m[i]) > 0.f) ? to_float(v[i]) : neg_inf;
  }
  __syncthreads();

  int cur = 0;
  for (int y = 1; y < y_len; ++y) {
    const float* qp = q + cur * tx;
    float* qn = q + (1 - cur) * tx;
    // every thread runs every chunk, so that each warp's ballot is whole
    for (int x0 = 0; x0 < tx; x0 += blockDim.x) {
      const int x = x0 + threadIdx.x;
      bool diag = false;
      if (x < tx) {
        const size_t i = (size_t)x * ty + y;
        const float val = to_float(m[i]) > 0.f ? to_float(v[i]) : neg_inf;
        const float stay = qp[x];
        const float shifted = x > 0 ? qp[x - 1] : neg_inf;
        diag = shifted >= stay;
        qn[x] = val + nan_max(shifted, stay);
      }
      const unsigned bits = __ballot_sync(0xffffffffu, diag);
      const int word = (x0 + threadIdx.x - lane) / 32;
      if (lane == 0 && word < words) dirs[(size_t)y * words + word] = bits;
    }
    __syncthreads();
    cur ^= 1;
  }

  if (threadIdx.x == 0) {
    int x = 0;
    for (int y = ty - 1; y >= 0; --y) {
      const bool active = y < y_len;
      if (y == y_len - 1) x = x_len - 1;
      xs[y] = active ? x : -1;
      if (active && y > 0) {
        // a negative x (only reachable through -inf scores in row 0) reads
        // its bit Python-style, from the end, as the plain version indexes
        const int xi = x < 0 ? x + tx : x;
        x -= (dirs[(size_t)y * words + xi / 32] >> (xi & 31)) & 1u;
      }
    }
  }
  __syncthreads();

  for (int x = 0; x < tx; ++x) {
    const size_t row = (size_t)x * ty;
    for (int y = threadIdx.x; y < ty; y += blockDim.x) {
      out[row + y] = from_float<TV>(xs[y] == x ? to_float(m[row + y]) : 0.f);
    }
  }
}

template <typename TV, typename TM>
int launch(const void* value, const void* mask, const int* x_lens, const int* y_lens,
           void* path, int batch, int tx, int ty, void* stream) {
  const int words = (tx + 31) / 32;
  const size_t smem = sizeof(float) * 2 * (size_t)tx + sizeof(unsigned) * (size_t)ty * words
                      + sizeof(int) * (size_t)ty;
  const int threads = tx >= 1024 ? 1024 : 32 * words;
  cudaError_t err = cudaFuncSetAttribute(
      mas_kernel<TV, TM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  mas_kernel<TV, TM><<<batch, threads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const TV*>(value), reinterpret_cast<const TM*>(mask), x_lens, y_lens,
      reinterpret_cast<TV*>(path), tx, ty, words);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// value and path: (batch, tx, ty) of value_type; mask: (batch, tx, ty) of
// mask_type (0 = float32, 1 = bfloat16); x_lens, y_lens: (batch,) int32 in
// [1, tx] and [1, ty]. Launches on `stream`; returns cudaGetLastError() after
// the launch (0 on success, and for an empty batch).
int mas_forward(const void* value, const void* mask, const int* x_lens, const int* y_lens,
                void* path, int batch, int tx, int ty, int value_type, int mask_type,
                void* stream) {
  if (batch <= 0) return 0;
  if (tx <= 0 || ty <= 0 || value_type < 0 || value_type > 1 || mask_type < 0 ||
      mask_type > 1)
    return (int)cudaErrorInvalidValue;
  if (value_type == 0) {
    return mask_type == 0
               ? launch<float, float>(value, mask, x_lens, y_lens, path, batch, tx, ty, stream)
               : launch<float, __nv_bfloat16>(value, mask, x_lens, y_lens, path, batch, tx, ty,
                                              stream);
  }
  return mask_type == 0
             ? launch<__nv_bfloat16, float>(value, mask, x_lens, y_lens, path, batch, tx, ty,
                                            stream)
             : launch<__nv_bfloat16, __nv_bfloat16>(value, mask, x_lens, y_lens, path, batch,
                                                    tx, ty, stream);
}

const char* mas_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
